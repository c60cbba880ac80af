"""IVF index persistence: k-means centers + assignment (a copy of
`leann_tpu/store/ivffile.py`; the same `.ivf.npz` bytes).

The packed bucket tables are derived (cheaply, one argsort) at load
time, so the on-disk artifact stays small: K x D centroids + N int32
assignments.
"""

from __future__ import annotations

import os

import numpy as np


def ivf_path(base: str) -> str:
    return base + ".ivf.npz"


class IvfFile:
    def __init__(
        self,
        centers: np.ndarray,
        assign: np.ndarray,
        metric: str = "ip",
        trained_n: int | None = None,
    ):
        self.centers = np.asarray(centers, dtype=np.float32)
        self.assign = np.asarray(assign, dtype=np.int32)
        self.metric = metric
        # corpus size when the centroids were last trained — incremental
        # updates assign to fixed centers, and the drift ratio
        # (n - trained_n) / n decides when a retrain is due
        self.trained_n = int(
            trained_n if trained_n is not None else len(self.assign)
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            centers=self.centers,
            assign=self.assign,
            metric=np.array(self.metric),
            trained_n=np.array(self.trained_n, dtype=np.int64),
        )

    @staticmethod
    def load(path: str) -> "IvfFile":
        with np.load(path, allow_pickle=False) as z:
            trained = int(z["trained_n"]) if "trained_n" in z else None
            return IvfFile(
                z["centers"], z["assign"], str(z["metric"]), trained
            )

    @staticmethod
    def exists(base: str) -> bool:
        return os.path.exists(ivf_path(base))
