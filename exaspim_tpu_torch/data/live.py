"""Live sampling datasets over whole-brain volumes.

Counterpart of ``exaspim_tpu/data/live.py``: stochastic foreground-biased
patch draws from lazily read whole-brain volumes (local stores or cloud
URLs through :mod:`exaspim_tpu_torch.utils.img_io`), BM4D teachers,
annotation masks from segmentations ∪ SWC skeletons (robust-intensity
fallback), the coherence artifact gate with a bounded resample loop,
per-brain background offsets and a fixed validation pool.

Sampling, masks and SWC parsing are host work (numpy / scipy), with the
reference's draw order: the same seed draws the same brains, voxels and
patches. The teacher runs the port's :func:`exaspim_tpu_torch.ops.bm4d.bm4d`
on the dataset's ``device`` (the card by default: two fused matcher
launches a patch); determinism comes from ``numpy.random.SeedSequence``
streams.

``__getitem__`` ignores its index and draws from the dataset's generator,
as in the reference. A copy of the dataset in each loader worker process
starts from the same generator state, so workers draw the same patches;
the cache writer (:mod:`exaspim_tpu_torch.data.precompute`) reseeds each
patch from its index instead. Its items run torch ops (the teacher), so
it is fetched in the loader's own process, never in forked workers
(``items_run_torch``).
"""

from __future__ import annotations

import concurrent.futures as _futures
import logging

import numpy as np

from exaspim_tpu_torch.ops.metrics import (
    make_foreground_mask,
    make_segmentation_mask,
    make_skeleton_mask,
    patch_has_incoherent_segment,
)
from exaspim_tpu_torch.utils import img_io
from exaspim_tpu_torch.utils.swc import Reader as SwcReader, to_voxels

logger = logging.getLogger(__name__)

__all__ = ["TrainDataset", "ValidateDataset", "init_datasets"]


def _teacher(raw, sigma, device="cuda"):
    """BM4D teacher in count space, computed on ``device``."""
    from exaspim_tpu_torch.ops.bm4d import bm4d

    den = bm4d(np.asarray(raw, np.float32), float(sigma), device=device)
    return np.clip(np.round(den.cpu().numpy()), 0, 65535).astype(np.uint16)


class _Brain:
    """Lazy per-brain state: image, optional segmentation, SWC voxels."""

    def __init__(self, brain_id, img, segmentation=None, swc_voxels=None,
                 offset=0):
        self.brain_id = brain_id
        self.img = img
        self.segmentation = segmentation
        self.swc_voxels = swc_voxels  # (N, 3) voxel coords or None
        self.offset = int(offset)

    @property
    def shape(self):
        """(z, y, x) voxel shape of the brain image."""
        return tuple(self.img.shape[-3:])


class TrainDataset:
    """Stochastic foreground-biased patch sampler with BM4D teachers.

    ``__getitem__`` ignores its index and draws a fresh example;
    determinism comes from the dataset's seeded generator (reseed with
    :meth:`reseed`). ``device`` is where the teacher is computed.
    """

    fields = ("raw", "teacher", "fg")

    def __init__(self, patch_shape=(64, 64, 64), sigma_bm4d=16.0,
                 foreground_rate=0.8, boundary_buffer=5000,
                 skeleton_dilate=2, segmentation_dilate=0,
                 min_segmentation_volume=200, bright_k=6.0,
                 max_resample_attempts=4, check_incoherence=True,
                 preserve_foreground=False, seed=42,
                 anisotropy=(0.748, 0.748, 1.0),
                 samples_per_epoch=1024, device="cuda"):
        self.patch_shape = tuple(patch_shape)
        self.sigma_bm4d = float(sigma_bm4d)
        self.foreground_rate = float(foreground_rate)
        self.boundary_buffer = int(boundary_buffer)
        self.skeleton_dilate = int(skeleton_dilate)
        self.segmentation_dilate = int(segmentation_dilate)
        self.min_segmentation_volume = int(min_segmentation_volume)
        self.bright_k = float(bright_k)
        self.max_resample_attempts = int(max_resample_attempts)
        self.check_incoherence = bool(check_incoherence)
        self.preserve_foreground = bool(preserve_foreground)
        self.anisotropy = tuple(anisotropy)
        self.samples_per_epoch = int(samples_per_epoch)
        self.device = str(device)
        self.brains = {}
        self.reseed(seed)

    #: an item runs torch ops (the teacher), on any device: the loader
    #: fetches it in its own process
    items_run_torch = True

    def reseed(self, seed):
        """Deterministic stream: accepts an int or a SeedSequence."""
        if not isinstance(seed, np.random.SeedSequence):
            seed = np.random.SeedSequence(seed)
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------ ingest

    def ingest_brain(self, brain_id, img, segmentation=None,
                     swc_source=None, offset=0):
        """Register a brain: image (path or opened volume), optional
        segmentation volume, optional SWC source."""
        if isinstance(img, str):
            img = img_io.read(img)
        if isinstance(segmentation, str):
            segmentation = img_io.read(segmentation)
        swc_voxels = None
        if swc_source is not None:
            swc_voxels = self._load_swc_voxels(swc_source)
        self.brains[str(brain_id)] = _Brain(
            str(brain_id), img, segmentation, swc_voxels, offset
        )

    def _load_swc_voxels(self, source):
        reader = SwcReader(anisotropy=self.anisotropy)
        traces = reader.read(source) if not isinstance(
            source, dict
        ) else source
        pts = []
        for name, d in traces.items():
            voxels = to_voxels(d["xyz"], self.anisotropy)
            if len(voxels) > 1:
                # Sparse tracing warning: consecutive nodes further apart
                # than a patch edge leave mask gaps
                #.
                cheb = np.max(
                    np.abs(np.diff(voxels, axis=0)), axis=1
                )
                if cheb.max() > max(self.patch_shape):
                    logger.warning(
                        "SWC %s has edges up to %d voxels; skeleton "
                        "masks will have gaps", name, int(cheb.max()),
                    )
            pts.append(voxels)
        if not pts:
            return None
        return np.concatenate(pts, axis=0)

    # ----------------------------------------------------------- access

    def __len__(self):
        # Nominal epoch length for loaders; sampling is stochastic, so
        # this only sets the shuffle-permutation size and epoch cadence.
        return self.samples_per_epoch

    def __getitem__(self, index):
        raw, teacher, fg, _, _ = self.sample_example()
        return raw, teacher, fg

    def sample_example(self):
        """One training example: (raw, teacher, fg, brain_id, voxel)."""
        brain_id, voxel, raw = self.sample_clean()
        teacher = _teacher(raw, self.sigma_bm4d, self.device)
        fg = self.annotation_mask(brain_id, voxel, raw)
        return raw, teacher, fg, brain_id, voxel

    # ---------------------------------------------------------- sampling

    def sample_brain(self):
        """Uniform draw over ingested brain ids."""
        if not self.brains:
            raise RuntimeError("no brains ingested")
        ids = sorted(self.brains)
        return ids[int(self.rng.integers(len(ids)))]

    def sample_voxel(self, brain_id):
        """Foreground-rate coin flip between biased and uniform draws."""
        if self.rng.random() < self.foreground_rate:
            v = self.sample_foreground_voxel(brain_id)
            if v is not None:
                return v
        return self.sample_interior_voxel(brain_id)

    def sample_foreground_voxel(self, brain_id):
        """Prefer skeleton, then segmentation, then bright draws."""
        brain = self.brains[brain_id]
        choices = []
        if brain.swc_voxels is not None and len(brain.swc_voxels):
            choices.append(self.sample_skeleton_voxel)
        if brain.segmentation is not None:
            choices.append(self.sample_segmentation_voxel)
        choices.append(self.sample_bright_voxel)
        fn = choices[int(self.rng.integers(len(choices)))]
        return fn(brain_id)

    def sample_interior_voxel(self, brain_id):
        """Uniform draw away from volume boundaries."""
        shape = self.brains[brain_id].shape
        lo = [
            min(self.boundary_buffer, max((d - p) // 4, 0)) + p // 2
            for d, p in zip(shape, self.patch_shape)
        ]
        hi = [
            d - l for d, l in zip(shape, lo)
        ]
        return tuple(
            int(self.rng.integers(l, max(h, l + 1)))
            for l, h in zip(lo, hi)
        )

    def sample_skeleton_voxel(self, brain_id):
        """Traced node + jitter ≤ patch/4."""
        brain = self.brains[brain_id]
        pts = brain.swc_voxels
        node = pts[int(self.rng.integers(len(pts)))]
        jitter = self.rng.integers(
            [-p // 4 for p in self.patch_shape],
            [p // 4 + 1 for p in self.patch_shape],
        )
        v = node + jitter
        return self._clamp_center(brain_id, v)

    def _first_accepted_candidate(self, brain_id, read_fn, accept_fn,
                                  attempts):
        """Draw ``attempts`` candidate centers, read them concurrently,
        return the first (in submission order) whose patch passes
        ``accept_fn``.

        The RNG draws happen up front on the calling thread and acceptance
        is checked in submission order, so the result is deterministic
        regardless of IO completion order. Against remote (cloud) volumes
        this overlaps the network latency of all candidates.
        """
        centers = [self.sample_interior_voxel(brain_id)
                   for _ in range(attempts)]
        with _futures.ThreadPoolExecutor(
            max_workers=min(16, attempts)
        ) as pool:
            reads = [pool.submit(read_fn, v) for v in centers]
            for v, fut in zip(centers, reads):
                patch = fut.result()
                if patch is not None and accept_fn(patch):
                    pool.shutdown(wait=False, cancel_futures=True)
                    return v
        return None

    def sample_segmentation_voxel(self, brain_id, attempts=16):
        """Candidate centers containing at least one *single* segment of
        ``min_segmentation_volume`` voxels (per segment, not the total
        of labeled voxels)."""
        brain = self.brains[brain_id]

        def has_big_segment(patch):
            labeled = patch[patch > 0]
            if labeled.size < self.min_segmentation_volume:
                return False
            _, seg_sizes = np.unique(labeled, return_counts=True)
            return int(seg_sizes.max()) >= self.min_segmentation_volume

        return self._first_accepted_candidate(
            brain_id,
            lambda v: self._read_volume_patch(
                brain.segmentation, v, self.patch_shape
            ),
            has_big_segment,
            attempts,
        )

    def sample_bright_voxel(self, brain_id, attempts=16):
        """Candidate centers with robust-bright occupancy."""
        return self._first_accepted_candidate(
            brain_id,
            lambda v: self.read_counts(brain_id, v),
            lambda raw: make_foreground_mask(
                raw, k=self.bright_k, dilate=0
            ).mean() > 0.001,
            attempts,
        )

    def _clamp_center(self, brain_id, voxel):
        shape = self.brains[brain_id].shape
        return tuple(
            int(np.clip(v, p // 2, d - (p - p // 2)))
            for v, p, d in zip(voxel, self.patch_shape, shape)
        )

    # ------------------------------------------------------------- reads

    def _read_volume_patch(self, vol, center, shape):
        try:
            return img_io.get_patch(vol, center, shape)
        except ValueError:
            return None

    def read_counts(self, brain_id, voxel):
        """Patch read with per-brain offset subtraction."""
        brain = self.brains[brain_id]
        patch = self._read_volume_patch(brain.img, voxel, self.patch_shape)
        if patch is None:
            return None
        counts = np.asarray(patch, np.int64) - brain.offset
        return np.clip(counts, 0, 65535).astype(np.uint16)

    def sample_clean(self):
        """Draw patches until the coherence gate passes (bounded
        attempts; degrades to the last draw)."""
        last = None
        for _ in range(max(1, self.max_resample_attempts)):
            brain_id = self.sample_brain()
            voxel = self._clamp_center(
                brain_id, self.sample_voxel(brain_id)
            )
            raw = self.read_counts(brain_id, voxel)
            if raw is None:
                continue
            last = (brain_id, voxel, raw)
            if not self.check_incoherence:
                return last
            seg = self._segmentation_patch(brain_id, voxel)
            if seg is None or not patch_has_incoherent_segment(seg, raw):
                return last
        if last is None:
            raise RuntimeError("could not draw a valid patch")
        return last

    def _segmentation_patch(self, brain_id, voxel):
        brain = self.brains[brain_id]
        if brain.segmentation is None:
            return None
        return self._read_volume_patch(
            brain.segmentation, voxel, self.patch_shape
        )

    # -------------------------------------------------------------- masks

    def annotation_mask(self, brain_id, voxel, raw):
        """Segmentation ∪ skeleton; robust-intensity fallback."""
        mask = np.zeros(self.patch_shape, dtype=bool)
        used_annotation = False
        seg = self._segmentation_patch(brain_id, voxel)
        if seg is not None:
            mask |= make_segmentation_mask(
                seg, dilate=self.segmentation_dilate
            )
            used_annotation = True
        sk = self.skeleton_mask(brain_id, voxel)
        if sk is not None:
            mask |= sk
            used_annotation = True
        if not used_annotation:
            mask = make_foreground_mask(raw, k=self.bright_k)
        return mask

    def sample_intensity_values(self, n_patches=8):
        """Concatenated counts from random patches — the transform-
        calibration sample."""
        values = []
        for _ in range(n_patches):
            brain_id = self.sample_brain()
            voxel = self._clamp_center(
                brain_id, self.sample_voxel(brain_id)
            )
            raw = self.read_counts(brain_id, voxel)
            if raw is not None:
                values.append(raw.ravel())
        if not values:
            raise RuntimeError("no readable patches for calibration")
        return np.concatenate(values)

    def skeleton_mask(self, brain_id, voxel):
        """Rasterized SWC-node mask for the patch at ``voxel``."""
        brain = self.brains[brain_id]
        if brain.swc_voxels is None or not len(brain.swc_voxels):
            return None
        start = [
            v - p // 2 for v, p in zip(voxel, self.patch_shape)
        ]
        return make_skeleton_mask(
            brain.swc_voxels, start, self.patch_shape,
            dilate=self.skeleton_dilate,
        )


class ValidateDataset:
    """Fixed validation pool drawn once at init."""

    fields = ("raw", "teacher", "raw_counts", "fg")

    def __init__(self, train_dataset, n_examples=8, seed=1234):
        self.patch_shape = train_dataset.patch_shape
        self.examples = []
        rng_backup = train_dataset.rng
        train_dataset.reseed(np.random.SeedSequence([seed, 0x7A1]))
        try:
            for _ in range(n_examples):
                raw, teacher, fg, brain_id, voxel = (
                    train_dataset.sample_example()
                )
                self.examples.append((raw, teacher, fg, brain_id, voxel))
        finally:
            train_dataset.rng = rng_backup

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, index):
        raw, teacher, fg, _, _ = self.examples[index]
        return raw, teacher, raw, fg


def init_datasets(brains, patch_shape=(64, 64, 64), transform_cfg=None,
                  calibrate=False, n_val_examples=8, seed=42,
                  **dataset_kwargs):
    """Build (train, validate, transform) from a brain spec list.

    ``brains``: list of dicts with keys ``brain_id``, ``img`` (path or
    volume), optional ``segmentation``, ``swc``, ``offset`` (the JAX
    package's brain-spec format). Further keyword arguments, ``device``
    among them, go to :class:`TrainDataset`.
    """
    from exaspim_tpu_torch.transforms import (
        build_transform,
        calibrate_transform,
    )

    train = TrainDataset(
        patch_shape=patch_shape, seed=seed, **dataset_kwargs
    )
    for spec in brains:
        train.ingest_brain(
            spec["brain_id"], spec["img"],
            segmentation=spec.get("segmentation"),
            swc_source=spec.get("swc"),
            offset=spec.get("offset", 0),
        )
    transform = None
    if transform_cfg is not None:
        if calibrate:
            _, _, raw = train.sample_clean()
            transform_cfg = calibrate_transform(transform_cfg, raw)
        transform = build_transform(transform_cfg)
    val = ValidateDataset(train, n_examples=n_val_examples, seed=seed)
    return train, val, transform
