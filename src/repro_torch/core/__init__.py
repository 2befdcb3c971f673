"""Host-side formats and models: bitmask/block-sparse packing, conv
geometry, balancing, the §3.2 combining model and the Table-1 layer specs."""
