"""Fault supervision of training runs (``fault``). Sharding over cards
is not ported yet."""
