"""The SCD training dataset over a `.d` archive.

Counterpart of ``scd_resnet_tpu/data/dataset.SCDDataset`` (reference
datasets/scds/scdx16p100.py), on one card:

- the intake order keeps clips whose rotation-augment index is below
  ``argument_ratio``, is shuffled, and is cut to ``partition`` (144-161);
- the validation split is read from, or written to, the
  ``{dataset}.split.json`` profile with the reference's schema (163-186);
- the validation set is rendered once per target family (center, or
  corner with the tl/br heatmaps), in chunks of ``VALIDATION_CHUNK``
  clips, through the port's batch transform on the dataset's device, so
  through the K1 kernel on a card, and kept on the host (199-286,
  381-414);
- each epoch's shuffle is keyed by (seed, epoch), so a resumed run sees
  the epochs it would have seen (the JAX package's keys, so its
  single-device order and this one agree).

Samples live in one host array of the storage dtype; augmentation and
the label render run on the device per batch (``data/pipeline.py``).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.core.logging import Logger
from scd_resnet_tpu_torch.data.archive import read_archive
from scd_resnet_tpu_torch.data.pipeline import augment_and_render_batch

_NAME_RE = re.compile(r"^(?P<img>.+?)\.(?P<rep>\d+)\.(?P<clip>\d+)\.npy$")
VALIDATION_CHUNK = 256  # clips per pre-render call (one K1 launch each)


def as_storage(samples: np.ndarray, storage_dtype: str) -> np.ndarray:
    """Clips in the storage dtype: float32, float16, or uint8 (rounded
    and clipped to 0..255)."""
    if storage_dtype == "uint8" and samples.dtype != np.uint8:
        return np.clip(np.rint(samples), 0, 255).astype(np.uint8)
    if storage_dtype == "float16" and samples.dtype != np.float16:
        return samples.astype(np.float16)
    if storage_dtype == "float32" and samples.dtype != np.float32:
        return samples.astype(np.float32)
    return samples


class SCDDataset:
    """The archive in host memory, its split, and its epoch orders.

    Args:
      zip_path: `.d` archive path.
      data_split: a parsed split profile (the reference's
        ``{dataset}.split.json`` schema), or None for a fresh split.
      argument_ratio: keep clips whose rotation-augment index is below
        this (ARGUMENTRATIO).
      partition: fraction of the shuffled intake kept (PARTITION).
      train_subset: the training subset's name in the split profile
        (TRAINSUBSET, e.g. 'train16p100').
      test_set: validation clip count (TESTSET = 5760), capped at half
        the clips.
      heat_size: heatmap side; S // 4 by default.
      split_profile_path: where to write the split profile.
      seed: shuffling seed.
      storage_dtype: in-memory clip dtype.
      device: where the validation set is rendered.
    """

    def __init__(self, zip_path: str, data_split: Optional[Dict] = None, *,
                 argument_ratio: int = 16, partition: float = 1.0,
                 train_subset: str = "train16p100", test_set: int = 5760,
                 heat_size: Optional[int] = None,
                 split_profile_path: Optional[str] = None, seed: int = 42,
                 storage_dtype: str = "float32",
                 device: str | torch.device = "cuda"):
        Logger.log("Loading archive {} ...".format(zip_path))
        self.names, samples, self.locs, self.counts = read_archive(zip_path)
        self.samples = as_storage(samples, storage_dtype)
        self.storage_dtype = storage_dtype
        self.device = torch.device(device)
        if self.samples.ndim != 3 or len(self.names) == 0:
            raise ValueError("empty or malformed archive: {}".format(zip_path))
        self.heat_size = heat_size or self.samples.shape[1] // 4
        self.train_subset = train_subset
        rng = np.random.default_rng(seed)

        order: List[int] = []
        for raw_index, name in enumerate(self.names):
            match = _NAME_RE.match(name)
            if (int(match.group("rep")) if match else 0) < argument_ratio:
                order.append(raw_index)
        rng.shuffle(order)
        order = order[: int(len(order) * partition)]

        if data_split is None:
            Logger.log("No data split profile; selecting a fresh "
                       "validation set.")
            rng.shuffle(order)
            num_validation = min(int(round(test_set)),
                                 max(1, len(order) // 2))
            self.data_profile = {"validation": order[:num_validation],
                                 train_subset: order[num_validation:]}
            order = order[num_validation:]
        else:
            Logger.log("Extracting validation set from data split profile ...")
            self.data_profile = dict(data_split)
            if train_subset in self.data_profile:
                order = list(self.data_profile[train_subset])
            else:
                validation = set(self.data_profile["validation"])
                order = [x for x in order if x not in validation]
                self.data_profile[train_subset] = order

        self.order = list(order)
        if split_profile_path:
            with open(split_profile_path, "w") as f:
                json.dump(self.data_profile, f)
        self._seed = seed
        self._validation: Dict[bool, Dict] = {}
        Logger.log("Dataset ready: {} training / {} validation clips".format(
            len(self.order), len(self.data_profile["validation"])))

    # ---- validation ------------------------------------------------------

    def _render_validation(self, corner_targets: bool = False
                           ) -> Optional[Dict]:
        """Render the validation set once per target family, without
        augmentation (the JAX dataset's cache, keyed the same way).

        Layouts: ``xs = [(N, 1, S, S)]``; the center family's ``ys =
        [heat, tag mask, regr, loc records (N, K, 8), counts, indices]``,
        where ys[3] carries the float loc records for the [It] metrics, as
        the reference's getValidationSet does (scdx16p100.py:404-414); the
        corner families' ``ys = [heat, tag mask, regr, indices, tl, br]``."""
        if corner_targets in self._validation:
            return self._validation[corner_targets]
        val_ids = np.asarray(self.data_profile["validation"], np.int64)
        if len(val_ids) == 0:
            return None
        xs_parts, ys_parts = [], []
        for start in range(0, len(val_ids), VALIDATION_CHUNK):
            ids = val_ids[start:start + VALIDATION_CHUNK]
            xs, ys = augment_and_render_batch(
                torch.from_numpy(self.samples[ids]).to(self.device),
                torch.from_numpy(self.locs[ids]).to(self.device),
                torch.from_numpy(self.counts[ids]).to(self.device),
                self.heat_size, augment=False, corner_targets=corner_targets)
            xs_parts.append(xs.cpu())
            ys_parts.append([y.cpu() for y in ys])
        ys = [torch.cat(parts) for parts in zip(*ys_parts)]
        if not corner_targets:
            heat, mask, regr, indices = ys
            ys = [heat, mask, regr, torch.from_numpy(self.locs[val_ids]),
                  torch.from_numpy(self.counts[val_ids]), indices]
        self._validation[corner_targets] = {"xs": [torch.cat(xs_parts)],
                                            "ys": ys}
        return self._validation[corner_targets]

    def get_validation_set(self, validation_batch_size: int,
                           corner_targets: bool = False) -> List[Dict]:
        """The pre-rendered validation set of a target family in batches
        of ``validation_batch_size``; a remainder batch is dropped, and a
        set no larger than one batch is one batch (scdx16p100.py:381-414)."""
        validation = self._render_validation(corner_targets)
        if validation is None:
            return []
        total = int(validation["xs"][0].shape[0])
        if total <= validation_batch_size:
            return [validation]
        return [{"xs": [validation["xs"][0][sl]],
                 "ys": [y[sl] for y in validation["ys"]]}
                for sl in (slice(k * validation_batch_size,
                                 (k + 1) * validation_batch_size)
                           for k in range(total // validation_batch_size))]

    # ---- training --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.order)

    def steps_per_epoch(self, batch_size: int) -> int:
        """Batches per epoch (drop_last)."""
        return len(self.order) // batch_size

    def epoch_batches(self, batch_size: int, epoch: int, skip: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of host (samples, locs, counts) batches in the
        (seed, epoch)-keyed order, starting ``skip`` batches in."""
        rng = np.random.default_rng((self._seed, 7919, int(epoch)))
        order = np.asarray(self.order)
        order = order[rng.permutation(len(order))]
        for start in range(skip * batch_size,
                           self.steps_per_epoch(batch_size) * batch_size,
                           batch_size):
            idx = order[start:start + batch_size]
            yield self.samples[idx], self.locs[idx], self.counts[idx]

    def epoch_local_indices(self, batch_size: int, epoch: int, skip: int = 0
                            ) -> Iterator[np.ndarray]:
        """One epoch of index batches into the training rows as the
        trainer holds them on the card (``self.order``), in the
        (seed, epoch)-keyed order, starting ``skip`` batches in."""
        rng = np.random.default_rng((self._seed, 104729, int(epoch), 0))
        local = rng.permutation(len(self.order))
        for s in range(skip, self.steps_per_epoch(batch_size)):
            yield local[s * batch_size:(s + 1) * batch_size].astype(np.int64)
