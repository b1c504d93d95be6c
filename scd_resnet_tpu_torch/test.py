"""Analyse whole-slide images (the port's ``test.py``).

    python -m scd_resnet_tpu_torch.test slide1.png [slide2.png ...] \\
        (-m bundle.pt2 | -c ckpt -a centerOffsetRes10) [-o out.json] \\
        [--fit] [--dedupe R] [--keep-out-of-bounds] [--pipelined] \\
        [--max-resident-clips N] [--mesh] [--device cuda|cpu]

Counterpart of the root ``test.py`` (reference test.py:41-183). ``-m`` serves a traced bundle (``python -m
scd_resnet_tpu_torch.trace``) through the host-tiled path, in batches of
the bundle's batch; ``-c`` serves a checkpoint (the port's, the JAX
package's msgpack, or a reference ``.pth`` for ``centerOffset*``)
through the device-fused analyzer. ``--pipelined`` (with ``-c``) queues
every slide's device work before any is read back;
``--max-resident-clips`` streams each slide in column bands of at most
that many clips, with the same detections; ``--mesh`` (with ``-c``)
shards each slide's clips over every visible CUDA device. It writes (``-o``) or prints
``{"detections": [{"image", <the contract's fields>}...], "contract",
"images"}``, and with ``--fit`` (the centerOffset contract only) the
two-Gaussian fit of the Rhr histogram as ``gauss2``: a fit that does
not converge is written as ``null``, its reason as ``gauss2_error``, and
the detections are kept (the root ``test.py`` stops at scipy's error and
writes nothing). It runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

from scd_resnet_tpu_torch.core.logging import Logger


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="analyse whole-slide images (PyTorch port)")
    parser.add_argument("images", nargs="+", help="slide image paths")
    parser.add_argument("-m", dest="model", default=None,
                        help="traced bundle (python -m "
                             "scd_resnet_tpu_torch.trace)")
    parser.add_argument("-c", dest="checkpoint", default=None,
                        help="checkpoint, served with the device-fused "
                             "tiling")
    parser.add_argument("-a", dest="arch", default="centerOffsetRes10",
                        help="model profile for -c")
    parser.add_argument("-o", dest="output", default=None,
                        help="write the detections JSON here")
    parser.add_argument("--fit", action="store_true",
                        help="fit the two-Gaussian Rhr histogram")
    parser.add_argument("--dedupe", type=float, default=None,
                        help="suppress tile-overlap duplicates within this "
                             "radius (px)")
    parser.add_argument("--keep-out-of-bounds", action="store_true",
                        help="keep detections outside the slide (from the "
                             "padded margins)")
    parser.add_argument("--pipelined", action="store_true",
                        help="with -c: queue every slide's device work "
                             "before reading any back")
    parser.add_argument("--max-resident-clips", type=int, default=None,
                        help="stream each slide in column bands of at most "
                             "this many clips (same detections; excludes "
                             "--pipelined and --mesh)")
    parser.add_argument("--mesh", action="store_true",
                        help="with -c: shard each slide's clips over every "
                             "visible CUDA device")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv``; returns the result it writes."""
    from scd_resnet_tpu_torch.core.compile_cache import (
        enable_compilation_cache,
    )
    from scd_resnet_tpu_torch.core.device import (
        reproducible_float32,
        visible_cards,
    )
    from scd_resnet_tpu_torch.infer.analyse import (
        CONTRACT_FIELDS,
        analyse_images,
        fit_rhr,
        make_device_analyzer,
        read_gray_u8,
    )
    from scd_resnet_tpu_torch.infer.wrapper import (
        load_traced,
        load_wrapper,
        traced_meta,
    )
    from scd_resnet_tpu_torch.train.registry import get_model_profile

    parser = _parser()
    args = parser.parse_args(argv)
    if (args.model is None) == (args.checkpoint is None):
        parser.error("exactly one of -m (traced bundle) or -c (checkpoint) "
                     "required")
    if args.pipelined and not args.checkpoint:
        parser.error("--pipelined requires -c (the traced path is "
                     "host-tiled, one batch at a time)")
    if args.mesh and not args.checkpoint:
        parser.error("--mesh requires -c (the traced path is host-tiled, "
                     "single-device)")
    if args.max_resident_clips and (args.mesh or args.pipelined):
        parser.error("--max-resident-clips bounds in-flight memory; "
                     "--mesh/--pipelined hold more in flight by design")
    if args.mesh and args.device != "cuda":
        parser.error("--mesh shards over the CUDA devices; it excludes "
                     "--device cpu")
    bounds = None if args.keep_out_of_bounds else "slide"
    contract = get_model_profile(args.arch).family if args.checkpoint \
        else traced_meta(args.model)["contract"]
    if args.fit and contract != "centerOffset":
        # before any device work: the contract is known from the profile
        # or the bundle's meta.json
        parser.error("--fit needs the Rhr row, which only the centerOffset "
                     "contract carries (got '{}')".format(contract))
    enable_compilation_cache()
    reproducible_float32()

    if args.checkpoint:
        wrapper = load_wrapper(args.checkpoint, args.arch, args.device)
        mesh = visible_cards() if args.mesh else None
        if mesh is not None:
            Logger.info(":: test :: sharding clip batches over {} "
                        "device(s)".format(len(mesh)))
        Logger.info(":: test :: serving checkpoint {} as {} on {} with "
                    "device-fused tiling (contract '{}')".format(
                        args.checkpoint, args.arch, wrapper.device, contract))
        analyzers = {}

        def analyzer_for(gray):
            height, width = gray.shape
            if (width, height) not in analyzers:
                analyzers[(width, height)] = make_device_analyzer(
                    wrapper, width, height, dedupe_radius=args.dedupe,
                    bounds=bounds, mesh=mesh,
                    max_resident_clips=args.max_resident_clips)
            return analyzers[(width, height)]

        def analyse_one(path):
            gray = read_gray_u8(path)
            return analyzer_for(gray)(gray)
    else:
        model, input_shape = load_traced(args.model, args.device)
        Logger.info(":: test :: loaded traced bundle {}, input {}, contract "
                    "'{}'".format(args.model, input_shape, contract))

        def analyse_one(path):
            return analyse_images(model, path, dedupe_radius=args.dedupe,
                                  batch_size=input_shape[0], bounds=bounds,
                                  max_resident_clips=args.max_resident_clips)

    if args.pipelined:
        inflight = []
        for path in args.images:
            gray = read_gray_u8(path)
            analyzer = analyzer_for(gray)
            inflight.append((path, analyzer, analyzer.dispatch(gray)))
        results = [(path, analyzer.finish(rows))
                   for path, analyzer, rows in inflight]
    else:
        results = [(path, analyse_one(path)) for path in args.images]

    fields = CONTRACT_FIELDS[contract]
    register = []
    for path, detections in results:
        Logger.log("{}: {} detections".format(path, len(detections)))
        for det in detections:
            entry = {"image": path}
            entry.update(zip(fields, det))
            register.append(entry)
    # every slide analysed is listed, with or without detections: a score
    # over slides needs the empty ones too
    result = {"detections": register, "contract": contract,
              "images": list(args.images)}
    if args.fit and register:
        try:
            popt = fit_rhr([d["rhr"] for d in register])
        except RuntimeError as err:  # scipy's curve_fit did not converge
            result.update(gauss2=None, gauss2_error=str(err))
            Logger.warn(":: test :: no gauss2 fit: {}".format(err))
        else:
            result["gauss2"] = dict(zip(("a1", "m1", "s1", "a2", "m2",
                                         "s2"), map(float, popt)))
            Logger.info(":: test :: gauss2 fit: {}".format(
                result["gauss2"]))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
        Logger.log("wrote {}".format(args.output))
    else:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
