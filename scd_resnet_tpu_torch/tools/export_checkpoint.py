"""Export a checkpoint as a reference-loadable torch ``.pth``.

    python -m scd_resnet_tpu_torch.tools.export_checkpoint ckpt out.pth \\
        [-a centerOffsetRes10]

Counterpart of the root ``tools/export_checkpoint.py`` and the export
half of ``scd_resnet_tpu/core/torch_convert.py``. The port's
``centerOffset*`` residual and hourglass modules carry the reference's
module names (models/backbones/residuals.py, models/centerNetOffset.py,
the reference's StackHourglass), so the export is the profile's module's
own ``state_dict``, after a strict load of the checkpoint: a bare dict of
CPU tensors that the reference's ``CenterNetResidual`` or
``StackHourglass`` loads with ``strict=True``. The checkpoint is the
port's or the JAX package's msgpack one (``core/checkpoint.
load_state_dict``). The DCN profile and the other families have no
reference module to load into and are refused.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from scd_resnet_tpu_torch.core.checkpoint import load_state_dict
from scd_resnet_tpu_torch.core.logging import Logger
from scd_resnet_tpu_torch.train.registry import get_model_profile


def export_state_dict(checkpoint: str, arch: str) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of ``checkpoint`` for ``arch``."""
    model = get_model_profile(arch).build()
    model.load_state_dict(load_state_dict(checkpoint, arch), strict=True)
    return {k: v.detach().cpu().contiguous().clone()
            for k, v in model.state_dict().items()}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.export_checkpoint",
        description="export a checkpoint as a reference torch .pth")
    parser.add_argument("checkpoint",
                        help="the port's or the JAX package's checkpoint")
    parser.add_argument("output", help="torch state_dict output (.pth)")
    parser.add_argument("-a", dest="arch", default="centerOffsetRes10",
                        help="model profile (plain centerOffset residual or "
                             "hourglass)")
    args = parser.parse_args(argv)
    profile = get_model_profile(args.arch)
    if profile.family != "centerOffset" or profile.model_params.get("dcn"):
        Logger.err("export covers the plain centerOffset residual + "
                   "hourglass families (the reference's own deployable "
                   "architectures); got '{}'".format(args.arch))
        sys.exit(1)
    sd = export_state_dict(args.checkpoint, args.arch)
    torch.save(sd, args.output)
    Logger.log("wrote {} (reference naming for {}, {} tensors)".format(
        args.output, args.arch, len(sd)))


if __name__ == "__main__":
    main()
