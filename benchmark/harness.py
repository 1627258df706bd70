"""One run of one cell: set-up, the measured window of whole user fits, the
check of what the window produced, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model, the catalogue's width K and the data recipe, with its plain
reference ``reference/<name>.py``) and a traffic mix
(``traffic/<name>.json``: the entry, the cohort size G, the chains, the
ranks, the iterations of a fit and what it saves), and has its own file of
correctness limits (``workloads/<name>.json``). A metric is a reader
``metrics/<name>.py`` whose ``read(run)`` returns a number or None. The
harness finds all of them by name, so a new cell, mix or metric is new
files.

The window runs whole fits back to back, each from the seed's data to the
MAP: the program's construction, chunks, MAP and convergence checks,
checkpoints and finalisation. Every fit does a fixed amount of work (a
control that stops at ``maxiters`` and nowhere else). The window closes at
the end of the first fit that ends after ``seconds``; its rate is all the
chain-iterations of its fits over all its wall seconds.

What the benchmark reads inside the program, it reads from wrappers that it
puts around the program's functions (``Hooks``): the steps a fit ran and
their inputs and outputs (``models.gibbs.gibbs_step``), the initial draws
(``parallel.chains.init_chain_states``), and with ``trace`` the host-clock
spans of the ensemble's phases, a profiled stretch of the window and the
arguments of one call of each kernel.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import check as CK
from . import data as D
from . import profiling as PR
from . import workcount as W

FOREIGN = ("jax", "jaxlib", "flax", "bayesnmf_tpu")
NEVER = 10 ** 9


def foreign_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``bayesnmf_tpu_torch`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic,
    limits and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "benchmark")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"name": name, "chips": cell["chips"],
            "config": _json(os.path.join(root, entry["file"])),
            "traffic": _json(os.path.join(here, "traffic",
                                          cell["traffic"] + ".json")),
            "workload": _json(os.path.join(here, "workloads",
                                           name + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def load_reader(root: str, metric: str):
    """``read`` of the metric's reader, ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def time_ms(torch, fn, reps: int) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls after three
    (copied from bayesnmf_tpu_torch/utils/measure.py time_ms); the host
    clock off the card."""
    for _ in range(3):
        fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the ensemble's phases for the host-clock spans, as bench_torch.py's
# phase_clock splits a run: label by method
PHASES = (("__init__", "construct"), ("_run_chunk", "loop"),
          ("_check_convergence", "map_check"),
          ("_finalize_chain", "map_check"), ("_compute_maps", "map_check"),
          ("save_object", "checkpoint"))

# per path: the kernel wrappers whose calls are timed, (module key, name)
KERNELS = {"stream": (("S", "stream_pcol_update"),
                      ("S", "stream_erow_update"),
                      ("S", "stream_acol_update"),
                      ("U", "sample_prior_params"), ("U", "sample_R")),
           "fused": (("gibbs", "fused_gibbs_sweeps"),)}


class Hooks:
    """The wrappers the benchmark puts around the program's functions, and
    what they record. ``fit`` is the window's fit index (None outside the
    window)."""

    def __init__(self, torch, mods: dict, trace: bool, plan: dict):
        self.torch = torch
        self.mods = mods
        self.trace = trace
        self.plan = plan
        self.fit = None
        self.fit_seed = None
        self.sample = set()
        self.fit_steps = 0
        self.chunks = 0
        self.steps = []
        self.captures, self.starts = [], []
        self.spans = {label: [] for _, label in PHASES}
        self._inner = []
        self.prof = None
        self.prof_s = 0.0
        self.stretch = None
        self.stretch_steps = 0
        self.capture_kernels = False
        self.kernel_calls = {}
        self.saved = []

    # -- installation -------------------------------------------------------

    def _patch(self, owner, name, wrapper):
        self.saved.append((owner, name, getattr(owner, name),
                           name in vars(owner)))
        setattr(owner, name, wrapper)

    def install(self):
        gibbs, chains = self.mods["gibbs"], self.mods["chains"]
        self._patch(gibbs, "gibbs_step", self._step(gibbs.gibbs_step))
        self._patch(chains, "init_chain_states",
                    self._init(chains.init_chain_states))
        if self.trace:
            ens = self.mods["ChainEnsemble"]
            for name, label in PHASES:
                self._patch(ens, name, self._span(getattr(ens, name), label,
                                                  name == "_run_chunk"))
            for path_kernels in KERNELS.values():
                for key, name in path_kernels:
                    mod = self.mods[key]
                    self._patch(mod, name, self._kernel(getattr(mod, name),
                                                         name))

    def uninstall(self):
        for owner, name, f, own in reversed(self.saved):
            if own:
                setattr(owner, name, f)
            else:
                delattr(owner, name)
        self.saved = []

    # -- the fit boundaries ---------------------------------------------------

    def begin_fit(self, i: int, fit_seed: int, sample: set):
        self.fit, self.fit_seed, self.sample = i, fit_seed, sample
        self.fit_steps = self.chunks = 0

    def end_fit(self):
        if self.prof is not None:
            self._stop_profile()
        self.fit = None

    # -- wrappers -------------------------------------------------------------

    def _step(self, orig):
        @functools.wraps(orig)
        def gibbs_step(spec, data, hp, state, temperature, accept_all, *a,
                       **k):
            if self.fit is None:
                return orig(spec, data, hp, state, temperature, accept_all,
                            *a, **k)
            it = state["iter"]
            cap = None
            if it in self.sample:
                gen = state["gen"]
                C = state["params"]["P"].shape[0]
                ok = (it == self.fit_steps + 1 and gen.seed == self.fit_seed
                      and np.array_equal(gen.all_uids, np.arange(C)))
                cap = {"in": self._snap(state) | {
                    "seed": self.fit_seed, "uids": np.arange(C), "it": it,
                    "temperature": _clone(temperature),
                    "accept_all": _clone(accept_all)},
                    "identity_ok": ok}
            new_state, sample = orig(spec, data, hp, state, temperature,
                                     accept_all, *a, **k)
            C = new_state["params"]["P"].shape[0]
            self.steps.append(C)
            self.fit_steps += 1
            if self.prof is not None:
                self.stretch_steps += 1
            if cap is not None:
                cap["out"] = self._snap(new_state) | {
                    "row": _clone(sample["metrics"])}
                self.captures.append(cap)
            return new_state, sample
        return gibbs_step

    @staticmethod
    def _snap(state) -> dict:
        p, pr = state["params"], state["prior"]
        return {"P": _clone(p["P"]), "E": _clone(p["E"]), "A": _clone(p["A"]),
                "R": _clone(p["R"]), "Mu_p": _clone(pr["Mu_p"]),
                "Sigmasq_p": _clone(pr["Sigmasq_p"]),
                "Mu_e": _clone(pr["Mu_e"]),
                "Sigmasq_e": _clone(pr["Sigmasq_e"]),
                "acc_P": _clone(state["acc_P"]),
                "acc_E": _clone(state["acc_E"])}

    def _init(self, orig):
        @functools.wraps(orig)
        def init_chain_states(spec, hp, data, gen, n_chains, *a, **k):
            states = orig(spec, hp, data, gen, n_chains, *a, **k)
            if self.fit is not None:
                snap = self._snap(states)
                self.starts.append({k_: snap[k_] for k_ in (
                    "P", "E", "A", "R", "Mu_p", "Mu_e", "Sigmasq_p",
                    "Sigmasq_e")} | {"seed": self.fit_seed,
                                     "uids": np.arange(n_chains)})
            return states
        return init_chain_states

    def _span(self, orig, label, chunk):
        torch = self.torch

        @functools.wraps(orig)
        def span(*a, **k):
            if self.fit is None:
                return orig(*a, **k)
            if chunk:
                self._chunk_boundary()
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"ensemble/{label}"):
                    return orig(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                self.spans[label].append(dt - self._inner.pop())
                if self._inner:
                    self._inner[-1] += dt
        return span

    def _kernel(self, orig, name):
        @functools.wraps(orig)
        def kernel(*a, **k):
            if (self.capture_kernels and self.fit is not None
                    and name not in self.kernel_calls):
                self.kernel_calls[name] = (orig, _clone(a), _clone(k))
            return orig(*a, **k)
        return kernel

    # -- the profiled stretch -------------------------------------------------

    def _chunk_boundary(self):
        if self.prof is not None:
            self._stop_profile()
        if (self.fit == self.plan["fit"] and self.chunks == self.plan["chunk"]
                and self.stretch is None):
            self._start_profile()
        self.chunks += 1

    def _start_profile(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.stretch_steps = 0
        self._t_prof = time.perf_counter()
        self.prof_s += self._t_prof - t0

    def _stop_profile(self):
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall = t1 - self._t_prof
        self.prof.__exit__(None, None, None)
        self.prof_s += time.perf_counter() - t1
        self.stretch = {"prof": self.prof, "window_s": wall,
                        "steps": self.stretch_steps}
        self.prof = None
        self.capture_kernels = True


class Run:
    """What a metric's reader reads: the cell, its shape, the window's
    counts and, with ``trace``, the spans, the profiled stretch and the
    kernels' times."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def step_bound_s(self, C: int) -> float:
        """The least seconds of one step of C chains at this cell's shape."""
        return W.step_bound_s(self.K, self.N, self.G, C, self.learning)

    def bound_s(self, name: str, C=None) -> float:
        """W.kernel_bound_s of a component or the fused call at this cell's
        shape (C: the chains the window's steps ran, by default)."""
        return W.kernel_bound_s(name, self.K, self.N, self.G,
                                self.C if C is None else C, self.learning)


def _control(cc_cls, traffic, warm: bool):
    it = traffic["warm"] if warm else traffic
    return cc_cls(MAP_over=traffic["MAP_over"], MAP_every=traffic["MAP_every"],
                  miniters=0, maxiters=it["maxiters"], Ninarow_nochange=NEVER,
                  Ninarow_nobest=NEVER), it["post_warmup"]


def _fit(bt, cell, M, seed, device, warm=False):
    """One user fit of the cell's traffic; returns the ensemble."""
    tr = cell["traffic"]
    cc, post = _control(bt.ConvergenceControl, tr, warm)
    ranks = range(tr["ranks"][0], tr["ranks"][1] + 1)
    save = tr["checkpoint"]
    kw = dict(convergence_control=cc, post_warmup=post, seed=seed,
              store_E=tr["store_E"], periodic_save=save == "periodic",
              stream_sweeps=tr.get("stream_sweeps"), device=device)
    with tempfile.TemporaryDirectory() as tmp:
        out = None if save == "none" else os.path.join(tmp, "fit")
        if tr["entry"] == "ensemble":
            ens = bt.ChainEnsemble(M, ranks, n_chains=tr["n_chains"],
                                   rank_method=tr["rank_method"],
                                   output_dir=out, **kw)
            ens.run()
        elif tr["entry"] == "bic":
            ens = bt.fit(M, ranks, rank_method="BIC", output_dir=out,
                         **kw)["ensemble"]
        else:
            raise ValueError(f"unknown entry {tr['entry']!r}")
    return ens


def _finite(ens) -> bool:
    maps = [m for m in ens.MAP_per_chain if m is not None]
    return (len(maps) == ens.n_chains
            and all(np.all(np.isfinite(np.asarray(m["P"]))) for m in maps)
            and bool(np.all(np.isfinite(ens._metrics_all()[:, 1:8]))))


def _fit_seed(seed: int, i: int) -> int:
    """The chain seed of a run's fit ``i``: 0 the warm fit, then the
    window's."""
    return (int(seed) << 8) + i


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        cell: dict | None = None, keep: dict | None = None):
    """One run of the cell ``name``: (result dict, the check's lines for
    standard error). ``cell``: the loaded cell (load_cell), to run one not
    in BENCHMARK.json (the tests' small cells); ``keep``: a dict that gets
    what the check compared (control.py reads the control from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.models import updates as U
    from bayesnmf_tpu_torch.ops import stream_sweeps as S
    from bayesnmf_tpu_torch.parallel import chains

    cell = cell or load_cell(root, name)
    cfg, tr, wl = cell["config"], cell["traffic"], cell["workload"]
    on_card = torch.device(device).type == "cuda"
    K, G = cfg["K"], tr["G"]
    N = tr["ranks"][1]
    M, _ = D.synthetic(K, G, cfg["data"]["true_rank"], int(seed),
                       cfg["data"]["scale"])
    if on_card:
        from bayesnmf_tpu_torch.ops import _build

        _build.load_library()
    ens = _fit(bt, cell, M, _fit_seed(seed, 0), device, warm=True)
    path = ("stream" if ens.spec.stream_sweeps
            else "fused" if ens.spec.fused_sweeps else "other")
    learning = bool(ens.spec.learning_rank)
    sbfi = ens.spec.rank_method == "SBFI"
    del ens
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    hooks = Hooks(torch, {"gibbs": gibbs, "chains": chains, "S": S, "U": U,
                          "ChainEnsemble": bt.ChainEnsemble}, trace,
                  wl["trace"])
    hooks.install()
    n_iter = tr["maxiters"] + tr["post_warmup"]
    fits, walls, failed = [], [], 0
    t0 = time.perf_counter()
    try:
        while True:
            i = len(fits)
            hooks.begin_fit(i, _fit_seed(seed, i + 1), CK.sample_steps(
                seed, i, n_iter, tr["maxiters"], wl["replays_per_fit"]))
            n0, t1 = sum(hooks.steps), time.perf_counter()
            ens = _fit(bt, cell, M, _fit_seed(seed, i + 1), device)
            hooks.end_fit()
            failed += not _finite(ens)
            fits.append(sum(hooks.steps) - n0)
            walls.append(time.perf_counter() - t1)
            del ens
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        hooks.uninstall()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # a traced run's readings leave out the profiler's own start and stop
    run_rec = Run(cell=cell, K=K, N=N, G=G, C=tr["n_chains"],
                  learning=learning, path=path, trace=trace, setup_s=setup_s,
                  window_s=window_s - hooks.prof_s, chain_iters=sum(fits),
                  fits=fits,
                  steps=hooks.steps, spans=hooks.spans, stretch=None,
                  kernel_ms={})
    if trace:
        _trace_readings(torch, hooks, run_rec)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check, once the window has closed and its state is freed
    t_check = time.perf_counter()
    data = torch.as_tensor(M, device=device)
    ref = CK.load_reference(root, cfg["reference"])
    hp = ref.hyperpriors(N, float(np.asarray(M, np.float32).mean()))
    for cap in hooks.captures:
        cap["in"]["temperature"] = float(cap["in"]["temperature"])
    args = (ref, data, hp, hooks.captures, hooks.starts, path, N, sbfi,
            learning)
    got = CK.mismatch(*args)
    check_s = time.perf_counter() - t_check
    if keep is not None:
        keep.update(args=args, got=got)
    limits = wl["limits"]
    checks = {"mismatch_share": {"value": got["mismatch_share"],
                                 "limit": limits["mismatch_share"]}}
    correct = (got["mismatch_share"] <= limits["mismatch_share"]
               and got["steps"] >= len(fits) and got["starts"] == len(fits)
               and failed == 0 and path == tr["path"])

    metrics = {}
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    for m in wanted:
        v = load_reader(root, m["name"])(run_rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    res = {"correct": bool(correct), "attempted": len(fits), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run_rec.stretch is not None:
        dev["busy_s"] = run_rec.stretch["busy_s"]
        dev["window_s"] = run_rec.stretch["window_s"]
        res["breakdown"] = {"device_ops": run_rec.stretch["device_ops"],
                            "idle_gaps": run_rec.stretch["idle_gaps"]}
    res["checks"] = checks
    lines = [f"worst: {got['worst']}; steps compared {got['steps']}, starts "
             f"{got['starts']}, fits {len(fits)}, failed {failed}; path "
             f"{path} (the cell's: {tr['path']})",
             "fit seconds: " + " ".join(f"{w:.3f}" for w in walls)
             + f"; window {window_s:.3f} s, profiler {hooks.prof_s:.3f} s, "
             f"check {check_s:.3f} s"]
    if trace:
        lines.append("span seconds: " + ", ".join(
            f"{k} {sum(v):.3f} ({len(v)})" for k, v in hooks.spans.items())
            + "; kernel ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in run_rec.kernel_ms.items()))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return res, lines


def _trace_readings(torch, hooks: Hooks, run_rec: Run):
    """The profiled stretch's summary and the captured kernels' times."""
    if hooks.stretch is not None:
        st = hooks.stretch
        summ = PR.summarize(PR.read_trace(st.pop("prof")))
        run_rec.stretch = st | summ
    calls = hooks.kernel_calls
    reps = run_rec.cell["workload"].get("kernel_reps", 20)
    for name, (fn, a, k) in calls.items():
        if name in ("sample_prior_params", "sample_R"):
            continue
        run_rec.kernel_ms[name] = time_ms(torch, lambda: fn(*a, **k), reps)
    if "sample_prior_params" in calls and "sample_R" in calls:
        (f1, a1, k1), (f2, a2, k2) = (calls["sample_prior_params"],
                                      calls["sample_R"])
        run_rec.kernel_ms["prior_update"] = time_ms(
            torch, lambda: (f1(*a1, **k1), f2(*a2, **k2)), reps)
    hooks.kernel_calls = {}
