"""Fixed-shape batches and thread-pool prefetch (copy of
``ryolo_tpu/data/loader.py``: ``DataLoader`` :40, ``load_data`` :318).

Every batch has fixed shapes, ``T = max_targets`` target rows per image
(overflow truncated and counted in ``n_dropped``):

  * ``tgt``      (B, T, 6)   ``[cls, x, y, w, h, theta]`` normalized
  * ``tgt_csl``  (B, T, 180) CSL bins (csl mode only)
  * ``tgt_mask`` (B, T)      bool

With ``device_augment`` a batch carries render specs for
:func:`ryolo_tpu_torch.data.device_augment.render_batch` instead of
``images``: B base slots plus E = ceil(0.4·B) mixup-partner slots.  Each
sample's rng is seeded from ``(seed, epoch, index)``, so batches do not
depend on the prefetch order.  The multi-host ``shard`` option of the JAX
loader is not ported (it serves ``--dp``, a later slice).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np

from ryolo_tpu_torch.data.datasets import (MAX_TILES, CustomDataset,
                                           DOTADataset, UCASAODDataset)

IDENTITY_MINV = np.array([[1, 0, 0], [0, 1, 0]], np.float32)


class Batch(dict):
    """Dict batch with attribute access."""

    __getattr__ = dict.__getitem__


class DataLoader:
    def __init__(self, dataset, batch_size: int, csl: bool,
                 shuffle: bool = True, max_targets: int = 300,
                 seed: int = 42, drop_last: bool = False,
                 workers: int = 4, prefetch: int = 2,
                 device_augment: bool = False, device_cache: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.csl = csl
        self.shuffle = shuffle
        self.max_targets = max_targets
        self.seed = seed
        self.drop_last = drop_last
        self.workers = workers
        self.prefetch = prefetch
        self.epoch = 0
        self.n_dropped = 0
        # samples are render specs; a mixup draw beyond the E partner slots
        # falls back to an exact host-rendered identity spec
        self.device_augment = device_augment
        if device_augment and not getattr(dataset, "augment", False):
            raise ValueError("device_augment requires an augmenting dataset")
        # specs name rows of a device-resident tile bank instead of shipping
        # pixels; a batch whose mixup draws exceed the partner slots falls
        # back to pixel specs (consumers dispatch on the batch's keys)
        self.device_cache = device_cache
        if device_cache and not device_augment:
            raise ValueError("device_cache requires device_augment")
        self.extra_slots = max(1, -(-batch_size * 2 // 5))  # ceil(0.4·B)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, index: int):
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))

    def _sample(self, index: int):
        if self.device_augment:
            return self.dataset.get_render_spec(index, self._rng(index),
                                                banked=self.device_cache)
        return self.dataset.get_sample(index, self._rng(index))

    def _new_targets(self, b: int):
        T = self.max_targets
        csl = np.zeros((b, T, 180), np.float32) if self.csl else None
        return np.zeros((b, T, 6), np.float32), csl, np.zeros((b, T), bool)

    def _pack_labels(self, b, labels, tgt, csl, mask):
        T = self.max_targets
        n = min(len(labels), T)
        if len(labels) > T:
            self.n_dropped += len(labels) - T
        if n:
            tgt[b, :n] = labels[:n, 1:7]
            if self.csl:
                csl[b, :n] = labels[:n, 7:]
            mask[b, :n] = True

    def _with_targets(self, out: Batch, tgt, csl, mask) -> Batch:
        out.update(tgt=tgt, tgt_mask=mask)
        if self.csl:
            out["tgt_csl"] = csl
        return out

    def _collate(self, samples):
        """Host-rendered samples -> ``images`` (B, S, S, 3) float32 RGB."""
        s = self.dataset.img_size
        images = np.zeros((len(samples), s, s, 3), np.float32)
        tgt, csl, mask = self._new_targets(len(samples))
        paths = []
        for b, (path, img, labels) in enumerate(samples):
            paths.append(path)
            images[b] = img
            self._pack_labels(b, labels, tgt, csl, mask)
        return self._with_targets(Batch(images=images, paths=paths),
                                  tgt, csl, mask)

    def _identity_spec(self, index):
        """Host-rendered fallback spec (exact; used on mixup-slot
        overflow): the sample as one full-canvas tile, identity warp."""
        s = self.dataset.img_size
        path, img, labels = self.dataset.get_sample(index, self._rng(index))
        tiles = np.zeros((MAX_TILES, s, s), np.int32)
        u8 = np.round(img * 255.0).astype(np.int32)  # RGB, so pack directly
        tiles[0] = (u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)).T
        region = np.zeros((MAX_TILES, 4), np.float32)
        region[0] = [0, 0, s, s]
        spec = {"tiles": tiles, "region": region,
                "offset": np.zeros((MAX_TILES, 2), np.float32),
                "hsv": np.ones((MAX_TILES, 3), np.float32),
                "minv": IDENTITY_MINV.copy()}
        return path, spec, labels

    def _collate_specs(self, samples, indices):
        """Spec batch: B base slots + E mixup-partner slots (fixed shapes)."""
        B = len(samples)
        E = self.extra_slots
        s = self.dataset.img_size
        BS = B + E
        banked = self.device_cache
        if banked and sum(r is not None for _, _, r, _, _ in samples) > E:
            # partner slots exhausted: a banked spec has no pixel channel
            # for the host-rendered overflow sample, so this batch falls back
            # to pixel specs (same per-(seed, epoch, index) draws: exact)
            banked = False
            samples = [
                self.dataset.get_render_spec(i, self._rng(i), banked=False)
                for i in indices]
        tiles = (np.zeros((BS, MAX_TILES), np.int32) if banked
                 else np.zeros((BS, MAX_TILES, s, s), np.int32))
        region = np.zeros((BS, MAX_TILES, 4), np.float32)
        offset = np.zeros((BS, MAX_TILES, 2), np.float32)
        hsv = np.ones((BS, MAX_TILES, 3), np.float32)
        minv = np.tile(IDENTITY_MINV, (BS, 1, 1))
        flip = np.zeros((B, 2), bool)
        mix_idx = np.full((B,), -1, np.int32)
        mix_r = np.zeros((B,), np.float32)
        tgt, csl, mask = self._new_targets(B)
        paths = []

        def put(slot, spec):
            tiles[slot] = spec["tile_idx"] if banked else spec["tiles"]
            region[slot] = spec["region"]
            offset[slot] = spec["offset"]
            hsv[slot] = spec["hsv"]
            minv[slot] = spec["minv"]

        next_extra = B
        for b, ((path, specs, r, flips, labels), idx) in enumerate(
                zip(samples, indices)):
            if r is not None and next_extra >= B + E:
                # partner slots exhausted: host-render this sample (exact)
                path, spec, labels = self._identity_spec(idx)
                specs, r, flips = [spec], None, (False, False)
            paths.append(path)
            put(b, specs[0])
            flip[b] = flips
            if r is not None:
                put(next_extra, specs[1])
                mix_idx[b] = next_extra
                mix_r[b] = r
                next_extra += 1
            self._pack_labels(b, labels, tgt, csl, mask)

        tile_field = "spec_tile_idx" if banked else "spec_tiles"
        out = Batch(spec_region=region, spec_offset=offset, spec_hsv=hsv,
                    spec_minv=minv, spec_flip=flip, spec_mix_idx=mix_idx,
                    spec_mix_r=mix_r, paths=paths, **{tile_field: tiles})
        return self._with_targets(out, tgt, csl, mask)

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, 0xB00])
            ).shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            # keep `prefetch` batches in flight (cv2 releases the GIL)
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    idxs = next(it)
                except StopIteration:
                    return False
                pending.append(
                    (idxs, [pool.submit(self._sample, i) for i in idxs]))
                return True

            for _ in range(self.prefetch + 1):
                if not submit_next():
                    break
            while pending:
                idxs, futs = pending.pop(0)
                samples = [f.result() for f in futs]
                submit_next()
                if self.device_augment:
                    yield self._collate_specs(samples, idxs)
                else:
                    yield self._collate(samples)


DATASETS = {
    "UCAS_AOD": UCASAODDataset,
    "DOTA": DOTADataset,
    "custom": CustomDataset,
}


def load_data(data_dir, class_names, dataset_type, hyp, csl, img_size=608,
              batch_size=4, augment=False, shuffle=True, max_targets=300,
              drop_last=False, seed=42, workers=4, device_augment=False,
              cache_images=False, device_cache=False):
    """Dataset + loader factory (``lib/load.py:9-21`` of the reference).

    ``device_augment``: batches are render specs (the host only decodes
    and does label math).  ``device_cache``: the caller uploads
    ``dataset.build_tile_bank()`` once and batches carry bank rows
    (``spec_tile_idx``).  ``cache_images`` keeps decoded sources in RAM.
    """
    if dataset_type not in DATASETS:
        raise NotImplementedError(
            f"dataset type {dataset_type!r} not supported")
    dataset = DATASETS[dataset_type](
        data_dir, class_names, hyp, img_size=img_size, augment=augment,
        csl=csl, cache_images=cache_images)
    loader = DataLoader(dataset, batch_size, csl=csl, shuffle=shuffle,
                        max_targets=max_targets, drop_last=drop_last,
                        seed=seed, workers=workers,
                        device_augment=device_augment,
                        device_cache=device_cache)
    return dataset, loader
