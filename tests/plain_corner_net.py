"""A plain reference of the original CornerNet, for the port's tests.

CornerNet (Law & Deng, ECCV 2018, arXiv:1808.01244; princeton-vl/CornerNet
``models/CornerNet.py``, ``models/py_utils/kp.py`` and ``kp_utils.py``)
written again in plain float32 PyTorch, TF32 off: the stacked hourglass,
a top-left and a bottom-right branch a stack (a corner-pool module, then
heat, tag and offset heads), the loss over every stack (focal + pull +
push + smooth-L1 offsets, tags and offsets gathered at the corners), the
training targets and the pairing decode. It imports nothing of the JAX
package or of the port and no port kernel: the corner pools are running
maxima whose gradient goes to the first maximum in scan order (the
position where the running maximum took its value), as the published
C++ pools route it. Its parameter names are the port's
(``models/corner_net_legacy.CornerNetLegacy``), so one state dict loads
into both.

The published network, as here: a stem of a 7x7/s2 convolution (BN,
ReLU) to 128 and a stride-2 residual to ``dims[0]``; per stack an
``iterations``-level hourglass (a level: ``modules[0]`` residuals at its
width beside a stride-2 residual to the next width, the next level or
``modules[1]`` residuals, residuals back to its width, a 2x nearest
upsample, the sum), a 3x3 convolution to ``prediction_dim``, and the
branches; between stacks ``relu(BN(1x1(inter)) + BN(1x1(cnv)))`` and a
residual. A pool module: two 3x3 convolutions (BN, ReLU) to
``pool_width``, a directional running maximum on each (top and left for
the top-left corner, bottom and right for the bottom-right), a 3x3
convolution and BN of their sum plus a 1x1 convolution and BN of the
input, ReLU, and a 3x3 convolution (BN, ReLU). A head: a 3x3
convolution with bias to ``head_hidden``, ReLU, a 1x1 convolution with
bias.

Where this departs from the published description, it follows the
repository:

- one input channel (grayscale bright-field slides), not three;
- one category, not 80;
- the targets come from the repository's loc records ``[ctX, ctY, offX,
  offY, majX, majY, minL, halo]`` at heat-map scale, not from boxes: an
  object's corners are ``(c + off / 4) -/+ (|maj|, minL)``, their floors
  index the maps, the fractions are the offset targets, and a corner
  counts where its object is real and its floor lies on the map (an
  object counts where both corners do); each corner map stamps a
  Gaussian at the corner's truncation with the repository's corner
  radius (``intersection.py``'s, at IoU 0.5, from the object's width
  ``2 |maj|`` and height ``2 minL``), sigma a third of it, inside a box
  of half-width ``ceil(2 r)``, summed and clamped to 1 (the published
  code takes ``gaussian_radius`` and a ``(2 r + 1) / 6`` sigma, with
  the larger value where objects overlap);
- the decode ranks equal pair scores (the rejected pairs' -1 among them)
  by pair index, lower first; the published ``torch.topk`` leaves their
  order open.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
IOU = 0.5


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """TF32 off for cuDNN and cuBLAS while it runs, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 \
        = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class ConvBN(nn.Module):
    """k x k convolution (stride), BN (or a bias without it), ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                              bias=not with_bn)
        self.bn = _bn(cout) if with_bn else None

    def forward(self, x):
        x = self.conv(x)
        return torch.relu(self.bn(x) if self.bn is not None else x)


class Residual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _bn(cout)
        self.skip = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                  _bn(cout)) \
            if stride != 1 or cin != cout else None

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + (x if self.skip is None else self.skip(x)))


class Hourglass(nn.Module):
    def __init__(self, n: int, dims: Sequence[int], mods: Sequence[int]):
        super().__init__()
        cur, nxt = dims[0], dims[1]
        self.preserveCurrentDimension = nn.Sequential(
            *(Residual(cur, cur) for _ in range(mods[0])))
        self.changeDimension = nn.Sequential(
            Residual(cur, nxt, 2), *(Residual(nxt, nxt)
                                     for _ in range(mods[0] - 1)))
        self.embeddedHourglass = Hourglass(n - 1, dims[1:], mods[1:]) \
            if n > 1 else nn.Sequential(*(Residual(nxt, nxt)
                                          for _ in range(mods[1])))
        self.changeDimensionBack = nn.Sequential(
            *(Residual(nxt, nxt) for _ in range(mods[0] - 1)),
            Residual(nxt, cur))

    def forward(self, x):
        low = self.changeDimensionBack(self.embeddedHourglass(
            self.changeDimension(x)))
        return self.preserveCurrentDimension(x) + F.interpolate(
            low, scale_factor=2, mode="nearest")


class _RunningMax(torch.autograd.Function):
    """Running maximum along ``dim`` from its far end when ``reverse``;
    each output's gradient goes to the input where its running maximum
    first took that value."""

    @staticmethod
    def forward(ctx, x, dim, reverse):
        xs = x.flip(dim) if reverse else x
        n = xs.shape[dim]
        out = torch.empty_like(xs)
        source = torch.empty(xs.shape, dtype=torch.long, device=x.device)
        best = xs.select(dim, 0).clone()
        at = torch.zeros_like(best, dtype=torch.long)
        for i in range(n):
            xi = xs.select(dim, i)
            rises = xi > best
            best = torch.where(rises, xi, best)
            at = torch.where(rises, torch.full_like(at, i), at)
            out.select(dim, i).copy_(best)
            source.select(dim, i).copy_(at)
        ctx.save_for_backward(source)
        ctx.dim, ctx.reverse = dim, reverse
        return out.flip(dim) if reverse else out

    @staticmethod
    def backward(ctx, g):
        (source,) = ctx.saved_tensors
        gs = g.flip(ctx.dim) if ctx.reverse else g
        dx = torch.zeros_like(gs).scatter_add_(ctx.dim, source,
                                               gs.contiguous())
        return (dx.flip(ctx.dim) if ctx.reverse else dx), None, None


# (dim, reverse) of the top, left, bottom and right pools (NCHW): the top
# pool's output at row i is the maximum of rows i and below
TOP, LEFT, BOTTOM, RIGHT = (2, True), (3, True), (2, False), (3, False)


class PoolModule(nn.Module):
    def __init__(self, c: int, width: int, pools):
        super().__init__()
        self.pools = pools
        self.branch1 = ConvBN(c, width)
        self.branch2 = ConvBN(c, width)
        self.merge_conv = nn.Conv2d(width, c, 3, 1, 1, bias=False)
        self.merge_bn = _bn(c)
        self.skip_conv = nn.Conv2d(c, c, 1, bias=False)
        self.skip_bn = _bn(c)
        self.out = ConvBN(c, c)

    def forward(self, x):
        p1 = _RunningMax.apply(self.branch1(x), *self.pools[0])
        p2 = _RunningMax.apply(self.branch2(x), *self.pools[1])
        merged = self.merge_bn(self.merge_conv(p1 + p2))
        return self.out(torch.relu(merged + self.skip_bn(self.skip_conv(x))))


class Head(nn.Sequential):
    def __init__(self, c: int, hidden: int, out: int):
        super().__init__(ConvBN(c, hidden, with_bn=False),
                         nn.Conv2d(hidden, out, 1))


class Branch(nn.Module):
    def __init__(self, c: int, pool_width: int, head_hidden: int, pools,
                 categories: int):
        super().__init__()
        self.pool_block = PoolModule(c, pool_width, pools)
        self.heat = Head(c, head_hidden, categories)
        self.tag = Head(c, head_hidden, 1)
        self.regr = Head(c, head_hidden, 2)

    def forward(self, x):
        f = self.pool_block(x)
        return self.heat(f), self.tag(f), self.regr(f)


class CornerNet(nn.Module):
    """The network (module docstring); ``forward`` returns one dict a
    stack: ``{tl,br}_{heat,tag,regr}``."""

    def __init__(self, dims: Sequence[int], modules: Sequence[int],
                 iterations: int = 5, stacks: int = 2,
                 prediction_dim: int = 256, pool_width: int = 128,
                 head_hidden: int = 256, categories: int = 1,
                 stem_width: int = 128):
        super().__init__()
        cur = dims[0]
        self.stacks = stacks
        self.preprocess = nn.Sequential(ConvBN(1, stem_width, 7, 2),
                                        Residual(stem_width, cur, 2))
        self.hourglassStack = nn.ModuleList(
            Hourglass(iterations, dims, modules) for _ in range(stacks))
        self.redimConvolution = nn.ModuleList(
            ConvBN(cur, prediction_dim) for _ in range(stacks))
        for corner, pools in (("tl", (TOP, LEFT)), ("br", (BOTTOM, RIGHT))):
            setattr(self, corner, nn.ModuleList(
                Branch(prediction_dim, pool_width, head_hidden, pools,
                       categories) for _ in range(stacks)))
        self.shortcutLayers = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cur, cur, 1, bias=False), _bn(cur))
            for _ in range(stacks - 1))
        self.convPrevHourglass = nn.ModuleList(
            nn.Sequential(nn.Conv2d(prediction_dim, cur, 1, bias=False),
                          _bn(cur))
            for _ in range(stacks - 1))
        self.interHourglassLayers = nn.ModuleList(
            Residual(cur, cur) for _ in range(stacks - 1))

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        with float32_math():
            inter = self.preprocess(x)
            outs = []
            for s in range(self.stacks):
                cnv = self.redimConvolution[s](self.hourglassStack[s](inter))
                out = {}
                for corner in ("tl", "br"):
                    maps = getattr(self, corner)[s](cnv)
                    for name, value in zip(("heat", "tag", "regr"), maps):
                        out[corner + "_" + name] = value
                outs.append(out)
                if s < self.stacks - 1:
                    inter = torch.relu(self.shortcutLayers[s](inter)
                                       + self.convPrevHourglass[s](cnv))
                    inter = self.interHourglassLayers[s](inter)
            return outs


# -- targets -----------------------------------------------------------------

def corner_radius(width, height, t: float = IOU):
    """The repository's corner radius bound (intersection.py:40-44)."""
    sum_sq = width * width + height * height
    prod = width * height
    return ((2 * torch.sqrt(sum_sq) / prod)
            - torch.sqrt(4 * sum_sq / (prod * prod) - 16 * (1 - t) / sum_sq)) \
        / (8 / sum_sq)


def gaussian_map(at, width, height, valid, size: int) -> torch.Tensor:
    """(B, size, size): a Gaussian at ``trunc(at)`` (B, K, 2) for each
    valid object (module docstring)."""
    b, k = valid.shape
    cx, cy = torch.trunc(at[..., 0]), torch.trunc(at[..., 1])
    on = valid & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    out = torch.zeros((b, size, size), device=at.device)
    grid = torch.arange(size, dtype=torch.float32, device=at.device)
    for i in range(b):
        for j in range(k):
            if not on[i, j]:
                continue
            r = corner_radius(width[i, j], height[i, j])
            if not r > 0:
                r = torch.ones_like(r)
            dx = (grid - cx[i, j])[None, :]
            dy = (grid - cy[i, j])[:, None]
            sigma = r / 3
            g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
            box = torch.ceil(2 * r)
            out[i] += torch.where((dx.abs() <= box) & (dy.abs() <= box), g,
                                  torch.zeros_like(g))
    return out.clamp(max=1.0)


def targets(locs: torch.Tensor, present: torch.Tensor, size: int
            ) -> Dict[str, torch.Tensor]:
    """The training targets of (B, K, 8) loc records and their (B, K)
    mask of real objects: ``tl_heat``, ``br_heat`` (B, 1, S, S),
    ``mask`` (B, K), ``tl_regr``, ``br_regr`` (B, K, 2), ``tl_inds``,
    ``br_inds`` (B, K) flat indices (0 where the object does not
    count)."""
    locs = locs.float()
    half = torch.stack([torch.sqrt(locs[..., 4] ** 2 + locs[..., 5] ** 2),
                        locs[..., 6]], dim=-1)
    centre = locs[..., 0:2] + locs[..., 2:4] / 4
    width, height = 2 * half[..., 0], 2 * half[..., 1]
    out, masks = {}, []
    for corner, at in (("tl", centre - half), ("br", centre + half)):
        floor = torch.floor(at)
        on = present & (floor[..., 0] >= 0) & (floor[..., 0] < size) \
            & (floor[..., 1] >= 0) & (floor[..., 1] < size)
        inds = (floor[..., 1] * size + floor[..., 0]).long()
        out[corner + "_inds"] = torch.where(on, inds, torch.zeros_like(inds))
        out[corner + "_regr"] = at - floor
        out[corner + "_heat"] = gaussian_map(at, width, height, on,
                                             size)[:, None]
        masks.append(on)
    out["mask"] = masks[0] & masks[1]
    return out


# -- loss --------------------------------------------------------------------

def _gather(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) at (B, K) flat indices -> (B, K, C)."""
    b, c = feat.shape[:2]
    flat = feat.reshape(b, c, -1).permute(0, 2, 1)
    return flat[torch.arange(b)[:, None], inds]


def focal(preds: List[torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    pos, neg = gt.eq(1), gt.lt(1)
    neg_weights = torch.pow(1 - gt[neg], 4)
    loss = 0
    for pred in preds:
        pos_pred, neg_pred = pred[pos], pred[neg]
        pos_loss = (torch.log(pos_pred) * torch.pow(1 - pos_pred, 2)).sum()
        neg_loss = (torch.log(1 - neg_pred) * torch.pow(neg_pred, 2)
                    * neg_weights).sum()
        if pos_pred.nelement() == 0:
            loss = loss - neg_loss
        else:
            loss = loss - (pos_loss + neg_loss) / pos.float().sum()
    return loss


def pull_push(tag0: torch.Tensor, tag1: torch.Tensor, mask: torch.Tensor):
    num = mask.sum(dim=1, keepdim=True).float()
    tag0, tag1 = tag0.reshape(mask.shape), tag1.reshape(mask.shape)
    mean = (tag0 + tag1) / 2
    pull = (torch.pow(tag0 - mean, 2) / (num + 1e-4))[mask].sum() \
        + (torch.pow(tag1 - mean, 2) / (num + 1e-4))[mask].sum()
    pairs = (mask[:, None, :].long() + mask[:, :, None].long()).eq(2)
    num = num[:, :, None]
    dist = torch.relu(1 - torch.abs(mean[:, None, :] - mean[:, :, None]))
    dist = (dist - 1 / (num + 1e-4)) / ((num - 1) * num + 1e-4)
    return pull, dist[pairs].sum()


def regression(regr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    num = mask.float().sum()
    return F.smooth_l1_loss(regr[mask], gt[mask], reduction="sum") \
        / (num + 1e-4)


def loss(outs: List[Dict[str, torch.Tensor]], t: Dict[str, torch.Tensor]):
    """``(total, focal, pull, push, regr)`` over every stack: the parts
    summed over the stacks, the total their sum over the stack count."""
    def prob(x):
        return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)

    focal_l = focal([prob(o["tl_heat"]) for o in outs], t["tl_heat"]) \
        + focal([prob(o["br_heat"]) for o in outs], t["br_heat"])
    pull_l = push_l = regr_l = 0
    mask = t["mask"]
    for o in outs:
        pull, push = pull_push(_gather(o["tl_tag"], t["tl_inds"]),
                               _gather(o["br_tag"], t["br_inds"]), mask)
        pull_l, push_l = pull_l + pull, push_l + push
        regr_l = regr_l + regression(_gather(o["tl_regr"], t["tl_inds"]),
                                     t["tl_regr"], mask) \
            + regression(_gather(o["br_regr"], t["br_inds"]), t["br_regr"],
                         mask)
    total = (focal_l + pull_l + push_l + regr_l) / len(outs)
    return total, focal_l, pull_l, push_l, regr_l


def adam(params: Dict[str, torch.Tensor], state: Dict, lr: float,
         betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One bias-corrected Adam step on every parameter with a gradient."""
    state["t"] = t = state.get("t", 0) + 1
    with torch.no_grad():
        for k, p in params.items():
            g = p.grad
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(betas[0]).add_(g, alpha=1 - betas[0])
            v.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
            p.sub_(lr * (m / (1 - betas[0] ** t))
                   / (torch.sqrt(v / (1 - betas[1] ** t)) + eps))


# -- decode ------------------------------------------------------------------

def _topk(heat: torch.Tensor, k: int):
    b, c, h, w = heat.shape
    scores, inds = torch.topk(heat.reshape(b, -1), k)
    classes = torch.div(inds, h * w, rounding_mode="floor")
    inds = inds % (h * w)
    return scores, inds, classes, torch.div(inds, w,
                                            rounding_mode="floor").float(), \
        (inds % w).float()


def decode(out: Dict[str, torch.Tensor], k: int = 100,
           ae_threshold: float = 1.0, num_dets: int = 1000) -> torch.Tensor:
    """(B, num_dets, 8) rows ``[tlX, tlY, brX, brY, score, tlScore,
    brScore, category]`` of the last stack's maps: the top-``k`` corners
    of each map paired, a pair scoring the mean of its corners' scores,
    or -1 where their categories differ, their tags lie more than
    ``ae_threshold`` apart or the bottom-right corner is not below and
    right of the top-left one (offsets added)."""
    tl_s, tl_i, tl_c, tl_y, tl_x = _topk(torch.sigmoid(out["tl_heat"]), k)
    br_s, br_i, br_c, br_y, br_x = _topk(torch.sigmoid(out["br_heat"]), k)
    b = tl_s.shape[0]
    tl_r, br_r = _gather(out["tl_regr"], tl_i), _gather(out["br_regr"], br_i)
    tl_x = (tl_x + tl_r[..., 0]).view(b, k, 1).expand(b, k, k)
    tl_y = (tl_y + tl_r[..., 1]).view(b, k, 1).expand(b, k, k)
    br_x = (br_x + br_r[..., 0]).view(b, 1, k).expand(b, k, k)
    br_y = (br_y + br_r[..., 1]).view(b, 1, k).expand(b, k, k)
    boxes = torch.stack((tl_x, tl_y, br_x, br_y), dim=3)
    tl_t = _gather(out["tl_tag"], tl_i).view(b, k, 1)
    br_t = _gather(out["br_tag"], br_i).view(b, 1, k)
    tl_s, br_s = tl_s.view(b, k, 1).expand(b, k, k), \
        br_s.view(b, 1, k).expand(b, k, k)
    scores = (tl_s + br_s) / 2
    tl_c, br_c = tl_c.view(b, k, 1).expand(b, k, k), \
        br_c.view(b, 1, k).expand(b, k, k)
    scores = scores.clone()
    scores[tl_c != br_c] = -1
    scores[torch.abs(tl_t - br_t) > ae_threshold] = -1
    scores[br_x < tl_x] = -1
    scores[br_y < tl_y] = -1
    scores, inds = torch.sort(scores.reshape(b, -1), dim=1, descending=True,
                              stable=True)
    scores, inds = scores[:, :num_dets], inds[:, :num_dets]
    rows = torch.arange(b)[:, None]
    return torch.cat([boxes.reshape(b, -1, 4)[rows, inds],
                      scores[..., None],
                      tl_s.reshape(b, -1)[rows, inds][..., None],
                      br_s.reshape(b, -1)[rows, inds][..., None],
                      tl_c.reshape(b, -1)[rows, inds][..., None].float()],
                     dim=2)
