"""SWC neuron-tracing reader: files, directories, zips, cloud prefixes.

Copy of ``exaspim_tpu/utils/swc.py``: parse SWC content into
id/radius/parent/xyz arrays (``# OFFSET`` headers, soma nodes, radii over
100 read as nanometres), from single files, directories, zip archives and
``gs://`` prefixes (through :mod:`exaspim_tpu_torch.utils.util`).

Voxel conversion uses the ExaSPIM anisotropy (x, y, z µm/voxel) and
returns (z, y, x) voxel coordinates for skeleton-mask rasterization.
"""

from __future__ import annotations

import io
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["ANISOTROPY", "Reader", "to_voxels"]

ANISOTROPY = (0.748, 0.748, 1.0)  # µm per voxel in (x, y, z)


def to_voxels(xyz, anisotropy=ANISOTROPY):
    """Physical (x, y, z) µm → (z, y, x) voxel coordinates."""
    xyz = np.asarray(xyz, np.float64)
    voxels = xyz / np.asarray(anisotropy)
    return np.flip(voxels, axis=-1).astype(np.int64)


class Reader:
    """Parse SWC sources into per-neuron dicts of arrays."""

    def __init__(self, anisotropy=ANISOTROPY, min_size=0):
        self.anisotropy = tuple(anisotropy)
        self.min_size = int(min_size)

    # ------------------------------------------------------------ ingest

    def read(self, source):
        """Dispatch on source type: file / dir / zip / list / gs://
        prefix.

        Returns ``{name: swc_dict}``.
        """
        if isinstance(source, (list, tuple)):
            out = {}
            for s in source:
                out.update(self.read(s))
            return out
        source = str(source)
        if source.startswith("gs://"):
            return self.read_from_gcs(source)
        if os.path.isdir(source):
            out = {}
            entries = sorted(os.listdir(source))
            swcs = [e for e in entries if e.endswith(".swc")]
            zips = [e for e in entries if e.endswith(".zip")]
            for e in swcs + zips:
                out.update(self.read(os.path.join(source, e)))
            return out
        if source.endswith(".zip"):
            return self.read_from_zip(source)
        if source.endswith(".swc"):
            return self.read_from_file(source)
        raise ValueError(f"unsupported SWC source: {source!r}")

    def read_from_file(self, path):
        """Parse a single ``.swc`` file → ``{name: swc_dict}``."""
        with open(path) as f:
            content = [ln.strip() for ln in f]
        d = self.parse(content)
        name = os.path.splitext(os.path.basename(path))[0]
        return {name: d} if d is not None else {}

    def read_from_zip(self, zip_path):
        """Parse every ``.swc`` inside a zip archive."""
        out = {}
        with zipfile.ZipFile(zip_path) as zf:
            for info in zf.infolist():
                if not info.filename.endswith(".swc"):
                    continue
                with zf.open(info) as f:
                    content = [
                        ln.strip() for ln in
                        io.TextIOWrapper(f, encoding="utf-8")
                    ]
                d = self.parse(content)
                if d is not None:
                    name = os.path.splitext(
                        os.path.basename(info.filename)
                    )[0]
                    out[name] = d
        return out

    def read_from_gcs(self, prefix, max_workers=16):
        """Parallel read of ``.swc`` blobs under a GCS prefix."""
        from exaspim_tpu_torch.utils.util import cloud_filesystem, parse_cloud_path

        fs = cloud_filesystem(prefix)
        _, bucket, pre = parse_cloud_path(prefix)
        paths = [
            p for p in fs.find(f"{bucket}/{pre}") if p.endswith(".swc")
        ]

        def one(p):
            with fs.open(p) as f:
                content = [
                    ln.strip() for ln in
                    io.TextIOWrapper(f, encoding="utf-8")
                ]
            return os.path.splitext(os.path.basename(p))[0], self.parse(
                content
            )

        out = {}
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            for name, d in pool.map(one, paths):
                if d is not None:
                    out[name] = d
        return out

    # ------------------------------------------------------------- parse

    def parse(self, content):
        """SWC lines → dict of arrays (ids reindexed order-preserved).
        Returns None for traces smaller than ``min_size``."""
        processed = self.process_content(content)
        if processed is None:
            return None
        lines, offset = processed
        if len(lines) < self.min_size:
            return None
        n = len(lines)
        d = {
            "id": np.zeros(n, dtype=int),
            "radius": np.zeros(n, dtype=np.float32),
            "pid": np.zeros(n, dtype=int),
            "xyz": np.zeros((n, 3), dtype=np.float32),
            "soma_nodes": set(),
        }
        for i, line in enumerate(lines):
            parts = line.split()
            d["id"][i] = int(parts[0])
            d["radius"][i] = float(parts[-2])
            d["pid"][i] = int(parts[-1])
            d["xyz"][i] = [
                float(v) + o for v, o in zip(parts[2:5], offset)
            ]
            if int(parts[1]) == 1:
                d["soma_nodes"].add(int(parts[0]))
        # nm→µm heuristic: radii over 100 are assumed nanometers.
        if n and d["radius"][0] > 100:
            d["radius"] /= 1000.0
        return d

    @staticmethod
    def process_content(content):
        """Strip comment header; honor ``# OFFSET x y z``."""
        offset = [0.0, 0.0, 0.0]
        for i, line in enumerate(content):
            if line.startswith("# OFFSET"):
                offset = [float(v) for v in line.split()[2:5]]
            if line and not line.startswith("#"):
                return content[i:], offset
        return None

    # ----------------------------------------------------------- voxels

    def voxels(self, swc_dict):
        """(z, y, x) voxel coordinates of a parsed trace's nodes."""
        return to_voxels(swc_dict["xyz"], self.anisotropy)
