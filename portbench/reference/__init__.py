"""The plain reference of the served semantics (``kv.py``): numpy only,
nothing of the program under test."""
