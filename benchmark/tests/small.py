"""Small cells for the CPU tests: a benchmark cell with the catalogue cut
to 12 rows and 40 genomes, 2-3 chains over ranks 1..3 and fits of 10
iterations, on the path the cell names (the stream path forced, since the
program streams by itself only on a card). The ``fit`` kinds are the
``fit`` entry, one ``GibbsSampler`` on the fused path, at a fixed rank 3
(``fit``) and over ranks 1..3 by SBFI (``fit_sbfi``); no cell of
BENCHMARK.json runs that entry, so their traffic is written here over the
fused cell's. ``model`` updates the configuration's model, ``reference``
names another reference (its file under ``root``)."""

import copy
import os

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = {"stream": "sbs96_ens8_g10k", "bic": "sbs96_bic20_g1000",
         "fused": "sbs1536_ens8_g1000", "fit": "sbs1536_ens8_g1000",
         "fit_sbfi": "sbs1536_ens8_g1000"}
FIT_TRAFFIC = {"fit": {"entry": "fit", "rank": 3, "path": "fused"},
               "fit_sbfi": {"entry": "fit", "rank_method": "SBFI",
                            "ranks": [1, 3], "path": "fused"}}


def small_cell(kind: str, model: dict | None = None,
               reference: str | None = None) -> dict:
    cell = copy.deepcopy(harness.load_cell(ROOT, CELLS[kind]))
    cell["config"]["K"] = 12
    cell["config"]["model"].update(model or {})
    cell["config"]["reference"] = reference or cell["config"]["reference"]
    if kind in FIT_TRAFFIC:
        base = cell["traffic"]
        cell["traffic"] = dict(FIT_TRAFFIC[kind],
                               checkpoint=base["checkpoint"])
    cell["traffic"].update(
        G=40, maxiters=6, post_warmup=4, MAP_every=2, MAP_over=4,
        warm={"maxiters": 2, "post_warmup": 2})
    if kind not in FIT_TRAFFIC:
        cell["traffic"].update(ranks=[1, 3],
                               n_chains=3 if kind == "bic" else 2)
    if kind == "stream":
        cell["traffic"]["stream_sweeps"] = True
    cell["workload"]["trace"] = {"fit": 0, "chunk": 1}
    return cell


def run_small(kind: str, seed: int = 12345678901, trace: bool = False,
              seconds: float = 0.0, keep=None, model=None, root=ROOT,
              reference=None):
    cell = small_cell(kind, model, reference)
    return harness.run(root, cell["name"], seed, seconds, trace, "cpu",
                       cell=cell, keep=keep)
