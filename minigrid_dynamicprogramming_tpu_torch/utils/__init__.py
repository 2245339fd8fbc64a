"""Host-side tools over the port's environments: the BabyAI oracle bot
(``babyai_bot.py``)."""
