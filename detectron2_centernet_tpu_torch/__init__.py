"""PyTorch / CUDA port of ``detectron2_centernet_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference this package is held against. The
port imports ``torch`` and numpy, never JAX and nothing of the JAX package.
Its layout mirrors that package: ``config``, ``structures``, ``data``,
``ops`` (the DCNv2 kernel and the ctdet decode), ``models``, ``checkpoint``
and ``engine``. Activations are NCHW; entry points run on the device named by
``cfg.MODEL.DEVICE`` (``"cuda"`` by default) and raise when it is missing.
"""
