"""Export a checkpoint as a traced decode bundle (the port's ``trace.py``).

    python -m scd_resnet_tpu_torch.trace out.pt2 -a centerOffsetRes10 \\
        -m model.pth -s '24 1 512 512' [--device cuda|cpu] [-wrapped]

Counterpart of the root ``trace.py`` (reference trace.py:14-33). ``-m``
takes any checkpoint the port reads: its own, the JAX package's msgpack,
or a reference ``.pth`` for ``centerOffset*``. The model and its
family's decode are exported with ``torch.export`` at the NCHW shape
``-s`` on ``--device`` (CUDA unless ``--device cpu``) and written as the
bundle ``infer/wrapper.save_traced`` describes, which
``python -m scd_resnet_tpu_torch.test -m`` serves without model code on
a device of the same type with the same torch. Every family exports
(``infer/wrapper.CONTRACTS``). ``-wrapped`` is accepted for the
reference CLI and ignored: the port's loader strips a DataParallel
prefix itself.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from scd_resnet_tpu_torch.core.logging import Logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="export a checkpoint as a traced decode bundle "
                    "(PyTorch port)")
    parser.add_argument("output", help="the bundle to write")
    parser.add_argument("-a", dest="arch", required=True,
                        help="model profile, e.g. centerOffsetRes10")
    parser.add_argument("-m", dest="model", required=True,
                        help="checkpoint: the port's, the JAX package's "
                             "msgpack, or a reference .pth")
    parser.add_argument("-s", dest="shape", required=True,
                        help="NCHW input shape, e.g. '24 1 512 512'")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("-wrapped", dest="wrapped", action="store_true",
                        help="accepted for the reference CLI; ignored")
    args = parser.parse_args(argv)
    try:
        args.shape = tuple(int(v) for v in args.shape.split())
    except ValueError:
        parser.error("-s takes four integers, got {!r}".format(args.shape))
    if len(args.shape) != 4 or args.shape[1] != 1:
        parser.error("-s takes an NCHW shape with one channel, got "
                     "{}".format(args.shape))
    if not os.path.exists(args.model):
        parser.error("checkpoint does not exist: {}".format(args.model))
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    from scd_resnet_tpu_torch.core.compile_cache import (
        enable_compilation_cache,
    )
    from scd_resnet_tpu_torch.core.device import reproducible_float32
    from scd_resnet_tpu_torch.infer.wrapper import load_wrapper, save_traced

    args = parse_args(argv)
    enable_compilation_cache()
    reproducible_float32()
    wrapper = load_wrapper(args.model, args.arch, args.device)
    out = wrapper(torch.zeros(args.shape, device=wrapper.device))
    Logger.log("{} on {} takes {} and returns {} (contract '{}': {})".format(
        args.arch, wrapper.device, args.shape, tuple(out.shape),
        wrapper.contract, wrapper.rows))
    save_traced(args.output, wrapper, args.shape)
    Logger.log("wrote {}".format(args.output))


if __name__ == "__main__":
    main()
