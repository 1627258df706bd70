"""Small cells for the CPU tests: a benchmark cell with the catalogue cut
to 12 rows and 40 genomes, 2-3 chains over ranks 1..3 and fits of 10
iterations, on the path the cell names (the stream path forced, since the
program streams by itself only on a card)."""

import copy
import os

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = {"stream": "sbs96_ens8_g10k", "bic": "sbs96_bic20_g1000",
         "fused": "sbs1536_ens8_g1000"}


def small_cell(kind: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(ROOT, CELLS[kind]))
    cell["config"]["K"] = 12
    cell["traffic"].update(
        G=40, ranks=[1, 3], n_chains=3 if kind == "bic" else 2, maxiters=6,
        post_warmup=4, MAP_every=2, MAP_over=4,
        warm={"maxiters": 2, "post_warmup": 2})
    if kind == "stream":
        cell["traffic"]["stream_sweeps"] = True
    cell["workload"]["trace"] = {"fit": 0, "chunk": 1}
    return cell


def run_small(kind: str, seed: int = 12345678901, trace: bool = False,
              seconds: float = 0.0, keep=None):
    cell = small_cell(kind)
    return harness.run(ROOT, cell["name"], seed, seconds, trace, "cpu",
                       cell=cell, keep=keep)
