"""PyTorch/CUDA port of scd_resnet_tpu, slice by slice.

The JAX package (``scd_resnet_tpu``) stays the reference; this package
imports nothing of it, nor of ``jax``/``flax``. Module names mirror the
JAX package (``ops/``, ``models/``, ``infer/``, ``core/``,
``train/registry.py``) so each counterpart is easy to find. Tensors are
NCHW; entry points take an explicit ``device`` and run on CUDA unless
the caller passes ``device="cpu"``.

Ported so far: every model profile of the JAX registry serves
(``python -m scd_resnet_tpu_torch.serve``; the slide CLI ``.test`` and
the exporter ``.trace``) and trains (``python -m
scd_resnet_tpu_torch.train``, with ``-debug`` overlays and
``SCD_PROFILE_*`` traces), slides and their label files become training
archives on the card (``python -m scd_resnet_tpu_torch.preprocess``),
and every Pallas kernel of the JAX package is a hand-written CUDA kernel
(``csrc/*.cu``). The parallel layer (``parallel/``) trains on a ``data``
x ``model`` mesh of ``torchrun`` ranks (cross-replica BatchNorm, summed
gradients, column-parallel wide kernels), pipelines the stacked
hourglass's stacks over a rank's cards (``pipe``, GPipe microbatches),
and shards a served slide's clips over cards (``serve --mesh``, ``test
--mesh``). The root tools have their counterparts in ``tools/``: the
north-star F1 pipeline through the port's CLIs, the F1 scorer, a
checkpoint's [It] line, the reference exporter, the label tools on
``data/labels.py`` and the serving daemon's load test. The host input
layer is C++ (``csrc/scdio.cpp`` through ``data/native_io``: the
threaded archive reader, the batch packer, the served grayscale), a
streamed epoch splits over ``torchrun`` nodes as JAX's splits over
hosts, and ``core/compile_cache`` keys every compiled library by the
machine and its compilers.
"""
