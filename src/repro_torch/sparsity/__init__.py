"""Offline pruning and packing: conv filters (``structured``, ``conv``)
and LM FFNs (``sparse_ffn``); MoE expert placement (``expert_balance``)."""
