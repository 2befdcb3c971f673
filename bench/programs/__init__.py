"""The program under test, one module per topology: a configuration's
``"topology"`` key names the stem of ``bench/programs/<topology>.py``
and of its reference, ``bench/reference/<topology>.py`` (``chain`` where
the key is absent).

A program module defines one function:

``build(config, filters, device)``
    The model that ``repro_torch.vision.engine.VisionEngine`` is built
    with, from the configuration and the dense filters that the benchmark
    made from the seed (``bench.inputs.make_inputs``).

It may import the program (``repro_torch``) inside ``build``, and never
JAX or the JAX package.
"""
