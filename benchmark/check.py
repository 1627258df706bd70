"""How ``correct`` is decided: the steps that the window ran, replayed by the
configuration's plain reference (``reference/<name>.py``) and compared with
what the program produced.

The reference cannot follow a chain over a whole fit: an MCMC chain is
chaotic, and a decision that lands within rounding of its threshold sends
the two sides apart. So it follows the program one step at a time from the
program's own state: for a sample of steps drawn from the seed it takes
the state the step was given (the chains' tensors, their iteration, the
temperature and the warm-up flags) and derives the step's output again,
draws included (the reference's own Philox). The start, which this skips,
is checked by itself: each fit's initial draws against the reference's.

The reference declares what it checks: ``STATE``, the tensors a replayed
step compares and where each sits in the program's state; ``START``, the
tensors of a start; ``STEPS``, the program's path name -> the step that
replays it. A path the reference does not declare is never replayed by
another path's step: the run compares nothing and reads 1.0.

The one number compared is ``mismatch_share``: over every replayed step and
every start, the largest share of a tensor's entries (each ``STATE``
tensor and the metrics row) on which the two sides differ by more than
``RTOL`` of the entry's size plus the tensor's mean size (each metrics
column its own). A decision within rounding of its threshold flips a few
entries of millions; a wrong or skipped update, a chain left out or
altered, or a state held in a lower precision moves a large share.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

RTOL = 1e-4


def load_reference(root: str, name: str):
    """The configuration's plain reference module, by name."""
    path = os.path.join(root, "benchmark", "reference", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def off_share(prog: torch.Tensor, ref: torch.Tensor,
              by_column: bool = False) -> float:
    """The share of entries on which ``prog`` and ``ref`` differ beyond the
    tolerance; both NaN counts as equal."""
    prog = prog.to(ref.device)
    if prog.shape != ref.shape:
        return 1.0
    if not ref.is_floating_point():
        return float((prog != ref).float().mean())
    p, r = prog.double(), ref.double()
    both_nan = torch.isnan(p) & torch.isnan(r)
    a = r.abs().nan_to_num(0.0, posinf=0.0, neginf=0.0)
    dims = 0 if by_column else tuple(range(1, r.dim()))
    scale = a.mean(dims, keepdim=True) if r.dim() > 1 else a.mean()
    same_inf = torch.isinf(p) & (p == r)
    gap = (p - r).abs()
    off = ~(both_nan | same_inf | (gap <= RTOL * (a + scale)))
    return float(off.float().mean())


def step_shares(ref_mod, prog: dict, ref: dict) -> dict:
    """name -> share for every tensor of a replayed step that ``ref_mod``
    declares, and the metrics row."""
    out = {k: off_share(prog[k], ref[k]) for k in ref_mod.STATE}
    out["row"] = off_share(prog["row"], ref["row"], by_column=True)
    return out


def replay(ref_mod, data, hp, cap: dict, path: str, N: int, sbfi: bool,
           learning: bool, rounding=None) -> dict:
    """The reference's output of a captured step's input, by the step it
    declares for ``path`` (KeyError for a path it does not declare)."""
    return ref_mod.STEPS[path](data, hp, cap["in"], N, sbfi, learning,
                               rounding)


def mismatch(ref_mod, data, hp, captures, starts, path, N, sbfi, learning,
             rounding=None, use_reference_output=False) -> dict:
    """{"mismatch_share": the largest share, "worst": where, "steps",
    "starts"}: the program's outputs (``use_reference_output``: the
    reference's own, computed in ``rounding`` against float32, for the
    control) against the reference's; 1.0 and nothing compared where the
    reference does not declare ``path``."""
    if path not in ref_mod.STEPS:
        return {"mismatch_share": 1.0,
                "worst": f"path {path} (not declared by the reference)",
                "steps": 0, "starts": 0, "by_tensor": {}}
    worst, where = -1.0, None
    G = data.shape[1]
    by_tensor = {}

    def note(v, at):
        nonlocal worst, where
        name = at.split()[-1]
        by_tensor[name] = max(by_tensor.get(name, 0.0), v)
        if v > worst:
            worst, where = v, at

    for i, cap in enumerate(captures):
        ok = cap.get("identity_ok", True)
        ref = replay(ref_mod, data, hp, cap, path, N, sbfi, learning)
        if use_reference_output:
            prog = replay(ref_mod, data, hp, cap, path, N, sbfi, learning,
                          rounding)
        else:
            prog = cap["out"]
        shares = step_shares(ref_mod, prog, ref) if ok else {"identity": 1.0}
        for k, v in shares.items():
            note(v, f"step {i} (iteration {cap['in']['it']}) {k}")
        del ref, prog
    for i, st in enumerate(starts):
        ref = ref_mod.init_draws(hp, st, N, G, learning)
        prog = (ref_mod.init_draws(hp, st, N, G, learning, rounding)
                if use_reference_output else st)
        for k in ref:
            note(off_share(prog[k], ref[k]), f"start {i} {k}")
    return {"mismatch_share": max(worst, 0.0), "worst": where,
            "steps": len(captures), "starts": len(starts),
            "by_tensor": by_tensor}


def sample_steps(seed: int, fit: int, n_steps: int, maxiters: int,
                 count: int) -> set:
    """The input iterations of fit ``fit`` whose steps are replayed: drawn
    from the seed, half in the warm-up (iterations 1..maxiters-1), half
    after it; ``n_steps`` the fit's last input iteration + 1 (a fit with
    no post-warm-up steps, ``n_steps`` = maxiters: all in the warm-up)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, fit])
    if n_steps <= maxiters:
        return set(int(x) for x in rng.integers(1, maxiters,
                                                size=max(count, 1)))
    warm = rng.integers(1, maxiters, size=max(count // 2, 1))
    post = rng.integers(maxiters, n_steps, size=max(count - count // 2, 1))
    return set(int(x) for x in np.concatenate([warm, post]))
