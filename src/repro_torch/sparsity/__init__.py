"""Offline pruning and packing: conv filters (``structured``, ``conv``)
and LM FFNs (``sparse_ffn``); magnitude pruning with fixed-mask
retraining (``pruning``); MoE expert placement (``expert_balance``);
activation-density probes (``instrument``)."""
