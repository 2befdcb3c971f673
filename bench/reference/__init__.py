"""The benchmark's yardstick: the plain reference of each topology, one
module per topology, and the work counts and peaks the per-layer metrics
divide by (``counts``). Imports nothing of the program under test.

A configuration's ``"topology"`` key names the stem of
``bench/reference/<topology>.py`` and of the program module of the same
topology (``chain`` where the key is absent). A reference module defines
four functions:

``prune_filters(config, dense)``
    The configuration's pruning of each dense [kh, kw, cin, cout] numpy
    filter, worked out again from the dense filters alone.
``device_filters(pruned, device)``
    The pruned filters in the form ``forward`` takes, on ``device``.
``forward(config, filters, x, precision="float32", masks_out=None)``
    The final maps of NHWC images ``x``. ``precision="tf32"`` is the
    control of the correctness check. ``masks_out``, when given,
    receives each convolution's two-sided MAC count per image (int64 [B]).
``map_bytes(config, size)``
    The bytes of every map read or written once, in fp32, for one square
    ``size`` image; its docstring says how a map that two layers read
    counts.
"""
