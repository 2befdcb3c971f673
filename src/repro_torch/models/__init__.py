"""Decoder LMs of the attention-only dense family: the layer library
(``layers``) and the whole model (``model``)."""
