"""Tensor pretty-printing and the container CLI (the port's own copy of
``xalm_tpu/obs/inspect.py``; the same text for the same container).

- ``format_tensor``: a table of per-row sparkline, min, max, mean and sum;
- ``save_csv``: a tensor (rank <= 2 as it is, higher ranks flattened to 2-D)
  as CSV;
- ``uniform``: the seed-42 uniform fixture;
- ``container_cli``:

      python -m xalm_tpu_torch.obs.inspect model.xalm [--dump NAME] [--hist] [--verify]

  lists the tensors (``--hist`` adds each one's distribution, dequantized),
  dumps one tensor's rows (``--dump``) and checks every content hash
  (``--verify``: exit 1 on a mismatch).
"""

from __future__ import annotations

import numpy as np

from xalm_tpu_torch.obs.stats import Histogram
from xalm_tpu_torch.obs.table import Table

__all__ = ["format_tensor", "save_csv", "uniform", "container_cli"]


def uniform(shape, low: float = -1.0, high: float = 1.0, seed: int = 42) -> np.ndarray:
    """Deterministic uniform test fixture (numpy, seed 42 by default)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=shape).astype(np.float32)


def save_csv(arr: np.ndarray, path: str, fmt: str = "%.8g") -> None:
    """Dump a tensor (rank<=2 as-is, higher ranks flattened to 2-D) to CSV."""
    a = np.asarray(arr)
    a = a.astype(np.float32) if a.dtype.kind not in "fiu" else a
    if a.ndim == 0:
        a = a.reshape(1, 1)
    elif a.ndim == 1:
        a = a.reshape(1, -1)
    elif a.ndim > 2:
        a = a.reshape(a.shape[0], -1)
    np.savetxt(path, a, fmt=fmt, delimiter=",")


def format_tensor(arr: np.ndarray, name: str = "", max_rows: int = 16) -> str:
    arr = np.asarray(arr)
    f = arr.astype(np.float32) if arr.dtype != np.float32 else arr
    title = f"{name} {arr.dtype} {'x'.join(map(str, arr.shape))}"
    tbl = Table(
        ["row", "histogram", "min", "max", "mean", "sum"],
        formats={c: "+.4g" for c in ("min", "max", "mean", "sum")},
    )
    rows = f.reshape(f.shape[0], -1) if f.ndim > 1 else f.reshape(1, -1)
    n = min(len(rows), max_rows)
    for i in range(n):
        h = Histogram(rows[i])
        tbl.add(i, h, float(h.min), float(h.max), float(h.mean), float(h.sum))
    if len(rows) > n:
        tbl.add("…", f"({len(rows) - n} more rows)", "", "", "", "")
    return tbl.format(title=title)


def container_cli(argv=None) -> int:
    """``python -m xalm_tpu_torch.obs.inspect model.xalm [--dump tensor]
    [--hist] [--verify]``: the container listing, tensor dumps and hash
    verification."""
    import argparse

    from xalm_tpu_torch import quant
    from xalm_tpu_torch.io import XalmFile

    p = argparse.ArgumentParser(prog="xalm-inspect")
    p.add_argument("checkpoint")
    p.add_argument("--dump", help="tensor name to dump with per-row histograms")
    p.add_argument("--hist", action="store_true",
                   help="add per-tensor distribution sparklines + min/max to "
                   "the listing (dequantizes every tensor)")
    p.add_argument("--verify", action="store_true", help="check all content hashes")
    args = p.parse_args(argv)

    with XalmFile(args.checkpoint) as xf:
        if args.dump:
            info = xf.tensors[args.dump]
            raw = xf.load(args.dump)
            scale = None
            sname = args.dump + ".scale"
            if info.dtype.name == "i8" and sname in xf.tensors:
                scale = xf.load(sname)
            vals = quant.dequantize(raw, info.dtype.name, scale)
            print(format_tensor(vals, args.dump))
        else:
            print(xf.format(histograms=args.hist))
            print(f"arch: {xf.arch}")
            for k, v in xf.config.items():
                print(f"  {k} = {v}")
        if args.verify:
            bad = [n for n in xf.tensors if not xf.verify(n)]
            if bad:
                print(f"HASH MISMATCH: {bad}")
                return 1
            print(f"all {len(xf.tensors)} tensor hashes verified")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(container_cli())
