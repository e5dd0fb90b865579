"""Shared app-driver scaffolding: load graph, report, check verdict."""
from __future__ import annotations

import logging

import numpy as np

from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.utils.config import RunConfig

log = logging.getLogger("lux_tpu_torch")


def load_graph(cfg: RunConfig) -> HostGraph:
    """The ``-file`` graph, else the synthetic RMAT of --rmat-scale /
    --rmat-ef / --seed."""
    if cfg.file:
        try:
            g = read_lux(cfg.file)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read {cfg.file}: {e}")
        log.info("loaded %s: nv=%d ne=%d", cfg.file, g.nv, g.ne)
        return g
    g = generate.rmat(cfg.rmat_scale, cfg.rmat_ef, seed=cfg.seed)
    log.info("synthetic graph: nv=%d ne=%d", g.nv, g.ne)
    return g


def print_check(name: str, violations: int) -> bool:
    """[PASS]/[FAIL] verdict line."""
    verdict = "[PASS]" if violations == 0 else "[FAIL]"
    print(f"{verdict} {name} check: {violations} violations")
    return violations == 0


def top_k(label: str, values: np.ndarray, k: int = 5):
    idx = np.argsort(values)[::-1][:k]
    print(f"top-{k} {label}: "
          + ", ".join(f"v{int(i)}={float(values[i]):.3e}" for i in idx))
