"""Fault supervision of training runs (``fault``) and the tensor-parallel
serving context (``tp``). Sharded training over cards is not ported
yet."""
