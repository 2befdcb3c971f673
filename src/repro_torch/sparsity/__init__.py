"""Offline pruning and packing: conv filters (``structured``, ``conv``)
and LM FFNs (``sparse_ffn``)."""
