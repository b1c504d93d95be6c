"""The plain reference of a training step, after the reference's
``datasets/scds/scdx16p100.py`` batch transform and its
``models/networkFactory.py`` step, in float32:

- the batch's flips (with the loc records' x or y mirrored on the heat
  map and the matching vector components negated), each clip standardised
  by its own mean and population variance, a variance jitter
  ``x * (1 + 0.05 j)`` and Gaussian noise ``+ 0.05 n``, from the draws the
  benchmark hands in;
- the labels: real objects whose centre is on the map, their flat heat-map
  indices, the regression targets ``[offX, offY, majX, majY, minL, halo]``
  and a Gaussian heat map a map, each object's at its truncated centre
  with radius ``center_threshold_radius(2 |maj|, 2 minL, 0.5)`` (and the
  corner maps at the centre -/+ (|maj|, minL) with the corner radius),
  sigma = r / 3, within a box of half-width ceil(2 r), summed and clamped
  to 1; the radii keep the reference's quadratic roots without the
  division by 2a;
- the forward in training mode (batch moments), the family's loss
  (``reference/<family>.py``: penalty-reduced focal losses on clamped
  sigmoids, :func:`focal`, and masked L1 terms, :func:`masked_l1`), the
  backward, and Adam (bias-corrected, no weight decay).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.reference.model import family as family_module
from portbench.reference.model import float32_math, identity


def center_radius(width, height, t: float) -> torch.Tensor:
    b1 = height + width
    c1 = width * height * (1 - t) / (1 + t)
    r1 = (b1 + torch.sqrt(b1 * b1 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - t) * width * height
    r2 = (b2 + torch.sqrt(b2 * b2 - 16 * c2)) / 2
    b3 = -2 * t * (height + width)
    c3 = (t - 1) * width * height
    r3 = (b3 + torch.sqrt(b3 * b3 - 4 * (4 * t) * c3)) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def corner_radius(width, height, t: float) -> torch.Tensor:
    sum_sq = width * width + height * height
    prod = width * height
    return ((2 * torch.sqrt(sum_sq) / prod)
            - torch.sqrt(4 * sum_sq / (prod * prod)
                         - 16 * (1 - t) / sum_sq)) / (8 / sum_sq)


def heat_map(locs, present, size: int, radius_fn, t: float,
             offset=None) -> torch.Tensor:
    """(B, size, size) Gaussian map of the objects (module docstring)."""
    px, py = locs[..., 0], locs[..., 1]
    if offset is not None:
        px, py = px + offset[..., 0], py + offset[..., 1]
    cx, cy = torch.trunc(px), torch.trunc(py)
    on = present & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    width = 2 * torch.sqrt(locs[..., 4] ** 2 + locs[..., 5] ** 2)
    radius = radius_fn(width, 2 * locs[..., 6], t)
    radius = torch.where(on & (radius > 0), radius, torch.ones_like(radius))
    sigma = radius / 3
    box = torch.ceil(2 * radius)
    grid = torch.arange(size, dtype=torch.float32, device=locs.device)
    out = torch.zeros((locs.shape[0], size, size), device=locs.device)
    for k in range(locs.shape[1]):
        dx = grid[None, None, :] - cx[:, k, None, None]
        dy = grid[None, :, None] - cy[:, k, None, None]
        g = torch.exp(-(dx * dx + dy * dy)
                      / (2 * sigma[:, k, None, None] ** 2))
        inside = (dx.abs() <= box[:, k, None, None]) \
            & (dy.abs() <= box[:, k, None, None]) & on[:, k, None, None]
        out = out + torch.where(inside, g, torch.zeros_like(g))
    return out.clamp(max=1.0)


def transform(samples, locs, counts, draws: Dict, heat: int, corner: bool,
              t: float, noise: float, jitter: float):
    """Clips and labels of one batch: ``(x (B, 1, S, S), labels)``."""
    x = samples.float()
    locs = locs.float()
    present = torch.arange(locs.shape[1], device=locs.device)[None] \
        < counts[:, None]
    for flip, image_dim, coords in ((draws["flip_h"], 2, (0, 2, 4)),
                                    (draws["flip_v"], 1, (1, 3, 5))):
        flipped = locs.clone()
        flipped[..., coords[0]] = heat - 1 - locs[..., coords[0]]
        flipped[..., coords[1]] = -locs[..., coords[1]]
        flipped[..., coords[2]] = -locs[..., coords[2]]
        x = torch.where(flip[:, None, None], x.flip(image_dim), x)
        locs = torch.where(flip[:, None, None], flipped, locs)
    centred = x - x.mean(dim=(1, 2), keepdim=True)
    var = centred.square().mean(dim=(1, 2), keepdim=True)
    x = torch.where(var > 0, centred / torch.sqrt(torch.where(
        var > 0, var, torch.ones_like(var))), torch.zeros_like(x))
    x = x * (1 + jitter * draws["jitter"]) + draws["noise"] * noise

    cx, cy = locs[..., 0], locs[..., 1]
    mask = present & (cx >= 0) & (cx < heat) & (cy >= 0) & (cy < heat)
    index = (torch.floor(cy) * heat + torch.floor(cx)).long()
    labels = {"mask": mask, "index": torch.where(mask, index,
                                                 torch.zeros_like(index)),
              "regr": locs[..., 2:8],
              "heatmap": heat_map(locs, present, heat, center_radius, t)}
    if corner:
        half = torch.stack([torch.sqrt(locs[..., 4] ** 2 + locs[..., 5] ** 2),
                            locs[..., 6]], dim=-1)
        labels["tl"] = heat_map(locs, present, heat, corner_radius, t, -half)
        labels["br"] = heat_map(locs, present, heat, corner_radius, t, half)
    return x[:, None], labels


def focal(logits, gt) -> torch.Tensor:
    pred = torch.sigmoid(logits.float()).clamp(1e-4, 1 - 1e-4)[:, 0]
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    pos_loss = (torch.log(pred) * (1 - pred) ** 2 * pos).sum()
    neg_loss = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4 * neg).sum()
    n = pos.sum()
    return -(pos_loss + neg_loss) / n if n > 0 else -neg_loss


def masked_l1(feature, index, target, mask) -> torch.Tensor:
    b, c = feature.shape[:2]
    pred = feature.float().reshape(b, c, -1).gather(
        2, index[:, None, :].expand(b, c, index.shape[1])).permute(0, 2, 1)
    m = mask.float()
    return ((pred - target).abs() * m[..., None]).sum() / (m.sum() + 1e-4)


class Trainer:
    """``model`` (its weights the starting state) under Adam, one
    :meth:`step` a batch, computed with ``quantize`` before every
    convolution."""

    def __init__(self, model: torch.nn.Module, config: Dict, heat: int,
                 quantize: Callable = identity):
        self.model, self.config, self.heat = model, config, heat
        self.quantize = quantize
        self.job = config["train"]
        self.params = dict(model.named_parameters())
        self.exp_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p)
                           for k, p in self.params.items()}
        self.family = family_module(config["family"])
        self.steps = 0

    def step(self, samples, locs, counts, draws: Dict) -> torch.Tensor:
        job = self.job
        lr, (b1, b2), eps = job["learningRate"], job["betas"], job["eps"]
        x, labels = transform(samples, locs, counts, draws, self.heat,
                              self.family.CORNER_MAPS, job["heatIou"],
                              job["noise"], job["jitter"])
        self.model.train()
        for p in self.params.values():
            p.grad = None
        with float32_math():
            value = self.family.loss(self.model(x, self.quantize), labels,
                                     job["lossWeights"])
            value.backward()
        self.steps += 1
        t = self.steps
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad
                self.exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
                self.exp_avg_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.exp_avg[k] / (1 - b1 ** t)
                v_hat = self.exp_avg_sq[k] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        return value.detach()


def run(model: torch.nn.Module, batches: List[Dict], config: Dict,
        heat: int, quantize: Callable = identity) -> Dict:
    """Train ``model`` on ``batches`` (``samples``, ``locs``, ``counts``,
    ``draws``), one Adam step each. Returns ``losses`` (floats), ``grad``
    (the first step's gradient by parameter name) and ``params`` (the
    parameters after the last step)."""
    trainer = Trainer(model, config, heat, quantize)
    losses, first = [], None
    for batch in batches:
        losses.append(trainer.step(batch["samples"], batch["locs"],
                                   batch["counts"], batch["draws"]).item())
        if first is None:
            first = {k: p.grad.detach().clone()
                     for k, p in trainer.params.items()}
    return {"losses": losses, "grad": first,
            "params": {k: p.detach().clone()
                       for k, p in trainer.params.items()}}
