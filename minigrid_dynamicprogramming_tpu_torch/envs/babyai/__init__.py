"""The BabyAI levels: the instruction verifier (``core.py``), the level
generator (``level.py``) and one module per family of levels."""
