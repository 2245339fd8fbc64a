"""Host-side tools over the port's environments: the BabyAI oracle bot
(``babyai_bot.py``), the ASCII printer and state digest (``debug.py``),
checkpoints (``checkpoint.py``), invariant guards and the NaN/Inf
tripwire (``guards.py``), generator telemetry (``telemetry.py``) and
tracing (``profiling.py``)."""
