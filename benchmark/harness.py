"""One run of one cell: set-up, the measured window of whole user fits, the
check of what the window produced, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model, the catalogue's width K and the data recipe, with its plain
reference ``reference/<reference>.py`` and its work count
``counts/<reference>.py``) and a traffic mix (``traffic/<name>.json``: the
entry, the cohort size G, the chains, the ranks, the iterations of a fit
and what it saves), and has its own file of correctness limits
(``workloads/<name>.json``). A metric is a reader ``metrics/<name>.py``
whose ``read(run)`` returns a number or None. The harness finds all of them
by name, so a new cell, mix, model or metric is new files.

The configuration's model reaches the program: its ``likelihood``,
``prior`` and ``MH`` go to every entry, any other key to an entry whose
class takes it, and after the warm fit every key is compared with the
program's spec (``model_gaps``); a key the program did not take up makes
the run not correct. The entries (``ENTRIES``): ``ensemble``, one
``ChainEnsemble``; ``bic``, ``fit(rank_method="BIC")``, one masked
ensemble; ``fit``, one ``GibbsSampler`` as a user's ``fit`` call builds it.
The path a run takes is named from the spec (``path_of``: stream, fused,
conjugate or eager), and the reference declares the paths it replays.

The window runs whole fits back to back, each from the seed's data to the
MAP: the program's construction, chunks, MAP and convergence checks,
checkpoints and finalisation. Every fit does a fixed amount of work (a
control that stops at ``maxiters`` and nowhere else). The window closes at
the end of the first fit that ends after ``seconds``; its rate is all the
chain-iterations of its fits over all its wall seconds.

What the benchmark reads inside the program, it reads from wrappers that it
puts around the program's functions (``Hooks``): the steps a fit ran and
their inputs and outputs (``models.gibbs.gibbs_step``), the initial draws
(``models.gibbs.init_state``), and with ``trace`` the host-clock spans of
the entry's phases, a profiled stretch of the window and the arguments of
the first call after it of each call that the reference times on the
run's path. A single chain's state, which has no chain axis, is kept as a
batch of one (uid 0), as the reference replays a batch.

The reference declares what a traced run times: ``TIMED``, path ->
{timing name: calls}, a call written ``"<module>:<attribute>"`` under
``bayesnmf_tpu_torch`` where the program looks the attribute up (``ops.
stream_sweeps:stream_pcol_update``). Each group is timed with CUDA events
over ``kernel_reps`` calls of its calls together, once each is captured,
into ``Run.kernel_ms[timing name]``. A declared call that does not exist
stops the run (``MissingCall``).

A traced run also records the program's own spans
(``bayesnmf_tpu_torch.utils.tracing``) over the window, and keeps the
profiled stretch's trace events, so that a reader puts the device's idle
time down to them (``attribution.py``). An untraced run, which gives the
end-to-end metrics, leaves the program's tracing off.
"""

from __future__ import annotations

import functools
import gc
import importlib
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import check as CK
from . import data as D
from . import profiling as PR

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


def load_count(root: str, reference: str):
    """The work count of the configurations whose reference is
    ``reference`` (``benchmark/counts/<reference>.py``: ``step_bound_s`` and
    ``kernel_bound_s``), or None where that model has none."""
    path = os.path.join(root, "benchmark", "counts", f"{reference}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"bench_count_{reference}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, metric: str):
    """``read`` of the metric's reader, ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _clone(x, lift=False):
    """A detached copy; ``lift``: a tensor gains a leading axis of one."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.unsqueeze(0).clone() if lift else x.clone()
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


# entry -> the program's class that it builds: its keywords are what the
# entry takes, its methods the phases that are spanned
ENTRIES = {"ensemble": "ChainEnsemble", "bic": "ChainEnsemble",
           "fit": "GibbsSampler"}

# each class's phases for the host-clock spans, as bench_torch.py's
# phase_clock splits a run: label by method; the profiled stretch opens at
# a ``loop`` span
PHASES = {"ChainEnsemble": (("__init__", "construct"), ("_run_chunk", "loop"),
                            ("_check_convergence", "map_check"),
                            ("_finalize_chain", "map_check"),
                            ("_compute_maps", "map_check"),
                            ("save_object", "checkpoint")),
          "GibbsSampler": (("__init__", "construct"), ("_run_chunk", "loop"),
                           ("_map_check", "map_check"),
                           ("save_object", "checkpoint"))}
# the prefix of the benchmark's spans in the trace, by class
SPAN_PREFIX = {"ChainEnsemble": "ensemble", "GibbsSampler": "sampler"}

PROGRAM = "bayesnmf_tpu_torch"


class MissingCall(LookupError):
    """A call that a reference's ``TIMED`` declares and the program does
    not have."""


def timed_calls(ref, path: str) -> dict:
    """{"<module>:<attribute>": (the module, the attribute)} of every call
    that the reference's ``TIMED[path]`` declares (none where it declares
    no group for ``path``); MissingCall names the first that does not
    exist."""
    out = {}
    for name, calls in ref.TIMED.get(path, {}).items():
        for call in calls:
            mod_name, _, attr = call.partition(":")
            mod = None
            if mod_name and attr:
                try:
                    mod = importlib.import_module(f"{PROGRAM}.{mod_name}")
                except ModuleNotFoundError as e:
                    if not (e.name or "").startswith(PROGRAM):
                        raise
            if mod is None or not hasattr(mod, attr):
                raise MissingCall(
                    f"TIMED[{path!r}][{name!r}]: {call} does not exist in "
                    f"{PROGRAM}")
            out[call] = (mod, attr)
    return out


class Hooks:
    """The wrappers the benchmark puts around the program's functions, and
    what they record. ``fit`` is the window's fit index (None outside the
    window). ``ref``: the configuration's reference, whose ``STATE`` and
    ``START`` say what a captured step and start keep and whose ``TIMED``
    names the calls a traced run times on ``path``; ``capture`` False (a
    path the reference does not declare) keeps no step or start.
    ``mods["entry"]``: the entry's class, whose ``PHASES`` are spanned.

    A step sampled for the check that falls inside the profiled stretch is
    captured at the first step after the stretch instead, so that the
    check's copies leave the stretch's device operations alone."""

    def __init__(self, torch, mods: dict, trace: bool, plan: dict, ref,
                 path: str, capture: bool = True):
        self.torch = torch
        self.mods = mods
        self.trace = trace
        self.plan = plan
        self.ref = ref
        self.path = path
        self.capture = capture
        self.in_step = False
        self.fit = None
        self.fit_seed = None
        self.sample = set()
        self.deferred = False
        self.fit_steps = 0
        self.chunks = 0
        self.steps = []
        self.captures, self.starts = [], []
        self.spans = {label: [] for phases in PHASES.values()
                      for _, label in phases}
        self._inner = []
        self.prof = None
        self.prof_s = 0.0
        self.stretch = None
        self.stretch_steps = 0
        self.capture_kernels = False
        self.timed = {}
        self.kernel_calls = {}
        self.saved = []

    # -- installation -------------------------------------------------------

    def _patch(self, owner, name, wrapper):
        self.saved.append((owner, name, getattr(owner, name),
                           name in vars(owner)))
        setattr(owner, name, wrapper)

    def install(self):
        # every declared call of the run's path is looked up, traced or not
        calls = timed_calls(self.ref, self.path)
        self.timed = self.ref.TIMED.get(self.path, {})
        gibbs = self.mods["gibbs"]
        self._patch(gibbs, "gibbs_step", self._step(gibbs.gibbs_step))
        self._patch(gibbs, "init_state", self._init(gibbs.init_state))
        if self.trace:
            cls = self.mods["entry"]
            prefix = SPAN_PREFIX[cls.__name__]
            for name, label in PHASES[cls.__name__]:
                self._patch(cls, name, self._span(
                    getattr(cls, name), f"{prefix}/{label}", label,
                    label == "loop"))
            for call, (mod, attr) in calls.items():
                self._patch(mod, attr, self._kernel(getattr(mod, attr),
                                                    call))

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
        self.deferred = False

    def end_fit(self):
        if self.prof is not None:
            self._stop_profile()
        self.fit = None

    # -- wrappers -------------------------------------------------------------

    def _step(self, orig):
        @functools.wraps(orig)
        def gibbs_step(spec, data, hp, state, temperature, accept_all, *a,
                       **k):
            # a single chain's fused step calls gibbs_step again on its
            # state lifted to a batch of one: that inner call is not a step
            if self.fit is None or self.in_step:
                return orig(spec, data, hp, state, temperature, accept_all,
                            *a, **k)
            one = _one_chain(state)
            it = state["iter"]
            cap = None
            due = self.capture and (it in self.sample or self.deferred)
            if due and self.prof is not None:
                self.deferred, due = True, False
            if due:
                self.deferred = False
                gen = state["gen"]
                C = 1 if one else state["params"]["P"].shape[0]
                ok = (it == self.fit_steps + 1 and gen.seed == self.fit_seed
                      and np.array_equal(gen.all_uids, np.arange(C)))
                acc = (self.torch.tensor([bool(accept_all)]) if one
                       else _clone(accept_all))
                cap = {"in": self._snap(state, self.ref.STATE) | {
                    "seed": self.fit_seed, "uids": np.arange(C), "it": it,
                    "temperature": _clone(temperature),
                    "accept_all": acc},
                    "identity_ok": ok}
            self.in_step = True
            try:
                new_state, sample = orig(spec, data, hp, state, temperature,
                                         accept_all, *a, **k)
            finally:
                self.in_step = False
            self.steps.append(1 if one else new_state["params"]["P"].shape[0])
            self.fit_steps += 1
            if self.prof is not None:
                self.stretch_steps += 1
            if cap is not None:
                cap["out"] = self._snap(new_state, self.ref.STATE) | {
                    "row": _clone(sample["metrics"], one)}
                self.captures.append(cap)
            return new_state, sample
        return gibbs_step

    def _snap(self, state, names) -> dict:
        """Copies of the tensors ``names`` of ``state`` (where the
        reference's ``STATE`` says each sits), a single chain's as a batch
        of one."""
        one = _one_chain(state)
        out = {}
        for name in names:
            group = self.ref.STATE[name]
            out[name] = _clone((state[group] if group else state)[name], one)
        return out

    def _init(self, orig):
        @functools.wraps(orig)
        def init_state(*a, **k):
            state = orig(*a, **k)
            if self.fit is not None and self.capture:
                C = 1 if _one_chain(state) else state["params"]["P"].shape[0]
                self.starts.append(self._snap(state, self.ref.START) | {
                    "seed": self.fit_seed, "uids": np.arange(C)})
            return state
        return init_state

    def _span(self, orig, name, label, chunk):
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
                with torch.profiler.record_function(name):
                    return orig(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                self.spans[label].append(dt - self._inner.pop())
                if self._inner:
                    self._inner[-1] += dt
        return span

    def _kernel(self, orig, call):
        @functools.wraps(orig)
        def kernel(*a, **k):
            if (self.capture_kernels and self.fit is not None
                    and call not in self.kernel_calls):
                self.kernel_calls[call] = (orig, _clone(a), _clone(k))
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
        self._t_prof_ns = time.perf_counter_ns()
        self._t_prof = time.perf_counter()
        self.prof_s += self._t_prof - t0

    def _stop_profile(self):
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1_ns = time.perf_counter_ns()
        t1 = time.perf_counter()
        wall = t1 - self._t_prof
        self.prof.__exit__(None, None, None)
        self.prof_s += time.perf_counter() - t1
        self.stretch = {"prof": self.prof, "window_s": wall,
                        "steps": self.stretch_steps,
                        "ns": (self._t_prof_ns, t1_ns)}
        self.prof = None
        self.capture_kernels = True


def _one_chain(state) -> bool:
    """A GibbsSampler's state: one chain, no chain axis (P is (K, N))."""
    return state["params"]["P"].dim() == 2


class Run:
    """What a metric's reader reads: the cell, its shape, the window's
    counts and, with ``trace``, the benchmark's spans, the profiled stretch
    (``stretch``: its summary; ``events``: its chrome-trace events;
    ``stretch_ns``: its bounds on ``time.perf_counter_ns``), the program's
    spans over the window (``program_spans``, ``tracing.take()``'s records)
    and the timed calls' times (``kernel_ms``). ``count``: the
    configuration's work count (load_count), None where its model has none;
    the bounds are then None, and ``missing_bound`` records that a reader
    asked for one."""

    count = None
    stretch = None
    events = None
    stretch_ns = None
    program_spans = ()

    def __init__(self, **kw):
        self.missing_bound = False
        self.__dict__.update(kw)

    def step_bound_s(self, C: int):
        """The least seconds of one step of C chains at this cell's shape,
        or None without a count."""
        if self.count is None:
            self.missing_bound = True
            return None
        return self.count.step_bound_s(self.K, self.N, self.G, C,
                                       self.learning)

    def bound_s(self, name: str, C=None):
        """The count's kernel_bound_s of a component or the fused call at
        this cell's shape (C: the chains the window's steps ran, by
        default), or None without a count."""
        if self.count is None:
            self.missing_bound = True
            return None
        return self.count.kernel_bound_s(name, self.K, self.N, self.G,
                                         self.C if C is None else C,
                                         self.learning)


def read_metric(reader, run: Run):
    """``reader``'s number, or None where it rests on a bound that the
    configuration's model has no count for (whatever the reader made of
    the None, an error of arithmetic on it included)."""
    run.missing_bound = False
    try:
        v = reader(run)
    except TypeError:
        if run.missing_bound:
            return None
        raise
    return None if run.missing_bound else v


def _control(cc_cls, traffic, warm: bool):
    it = traffic["warm"] if warm else traffic
    return cc_cls(MAP_over=traffic["MAP_over"], MAP_every=traffic["MAP_every"],
                  miniters=0, maxiters=it["maxiters"], Ninarow_nochange=NEVER,
                  Ninarow_nobest=NEVER), it["post_warmup"]


def ranks_of(traffic):
    """(the rank argument of the traffic's entry, its largest rank N): a
    fixed ``rank``, or ``ranks`` [lo, hi] as range(lo, hi + 1)."""
    if "rank" in traffic:
        return int(traffic["rank"]), int(traffic["rank"])
    lo, hi = traffic["ranks"]
    return range(lo, hi + 1), hi


def model_kw(model: dict, cls) -> dict:
    """The configuration's model keys that ``cls`` takes as keywords
    (likelihood, prior and MH every entry's class takes)."""
    takes = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in model.items() if k in takes}


def model_gaps(model: dict, spec) -> list:
    """Where the program's spec differs from the configuration's model:
    one line a key, with both values. Each key reads the spec's attribute
    of its name, but ``max_rank``, which bounds the spec's N (the traffic
    picks the ranks)."""
    gaps = []
    for key, want in model.items():
        if key == "max_rank":
            got, ok = spec.N, spec.N <= want
        else:
            got = getattr(spec, key, "(not taken up)")
            ok = got == want
        if not ok:
            gaps.append(f"model {key}: configuration {want!r}, program "
                        f"{got!r}")
    return gaps


def path_of(spec) -> str:
    """The path a step of ``spec`` takes, in models/gibbs.py gibbs_step's
    order: stream, conjugate (Poisson with MH off), eager or fused."""
    if spec.stream_sweeps:
        return "stream"
    if spec.likelihood == "poisson" and not spec.MH:
        return "conjugate"
    return "fused" if spec.fused_sweeps else "eager"


def _fit(bt, cell, M, seed, device, warm=False):
    """One user fit of the cell's traffic through its entry; returns the
    fitted ChainEnsemble or GibbsSampler."""
    tr = cell["traffic"]
    if tr["entry"] not in ENTRIES:
        raise ValueError(f"unknown entry {tr['entry']!r}")
    cc, post = _control(bt.ConvergenceControl, tr, warm)
    rank, _ = ranks_of(tr)
    save = tr["checkpoint"]
    kw = model_kw(cell["config"]["model"], getattr(bt, ENTRIES[tr["entry"]]))
    kw.update(convergence_control=cc, post_warmup=post, seed=seed,
              periodic_save=save == "periodic", device=device)
    # the ensemble's own options, where the traffic sets them
    kw.update({k: tr[k] for k in ("store_E", "stream_sweeps") if k in tr})
    with tempfile.TemporaryDirectory() as tmp:
        out = None if save == "none" else os.path.join(tmp, "fit")
        if tr["entry"] == "ensemble":
            fitted = bt.ChainEnsemble(M, rank, n_chains=tr["n_chains"],
                                      rank_method=tr["rank_method"],
                                      output_dir=out, **kw)
            fitted.run()
        elif tr["entry"] == "bic":
            fitted = bt.fit(M, rank, rank_method="BIC", output_dir=out,
                            **kw)["ensemble"]
        else:
            fitted = bt.fit(M, rank, rank_method=tr.get("rank_method",
                                                        "SBFI"),
                            output_dir=out, **kw)
    return fitted


def _finite(fitted) -> bool:
    """Every chain's MAP P and metrics rows (RMSE to rank) finite: an
    ensemble's, or a sampler's one chain."""
    if hasattr(fitted, "MAP_per_chain"):
        maps, n = fitted.MAP_per_chain, fitted.n_chains
        rows = fitted._metrics_all()[..., 1:8]
    else:
        maps, n = [fitted.MAP], 1
        rows = np.concatenate(fitted._metric_rows)[:, 1:8]
    maps = [m for m in maps if m is not None]
    return (len(maps) == n
            and all(np.all(np.isfinite(np.asarray(m["P"]))) for m in maps)
            and bool(np.all(np.isfinite(rows))))


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
    what the check compared (control.py reads the control from it, the
    tests the program's spec and the Run)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.utils import tracing

    cell = cell or load_cell(root, name)
    cfg, tr, wl = cell["config"], cell["traffic"], cell["workload"]
    on_card = torch.device(device).type == "cuda"
    K, G = cfg["K"], tr["G"]
    _, N = ranks_of(tr)
    M, _ = D.synthetic(K, G, cfg["data"]["true_rank"], int(seed),
                       cfg["data"]["scale"])
    if on_card:
        from bayesnmf_tpu_torch.ops import _build

        _build.load_library()
    fitted = _fit(bt, cell, M, _fit_seed(seed, 0), device, warm=True)
    spec = fitted.spec
    del fitted
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    path, learning = path_of(spec), bool(spec.learning_rank)
    sbfi = spec.rank_method == "SBFI"
    gaps = model_gaps(cfg["model"], spec)
    ref = CK.load_reference(root, cfg["reference"])
    declared = path in ref.STEPS

    hooks = Hooks(torch, {"gibbs": gibbs,
                          "entry": getattr(bt, ENTRIES[tr["entry"]])},
                  trace, wl["trace"], ref, path, capture=declared)
    hooks.install()
    # the steps a fit runs: the post-warm-up ones only with MH
    n_iter = tr["maxiters"] + (tr["post_warmup"] if spec.MH else 0)
    fits, walls, failed = [], [], 0
    program_spans = []
    if trace:
        tracing.enable()
    t0 = time.perf_counter()
    try:
        while True:
            i = len(fits)
            hooks.begin_fit(i, _fit_seed(seed, i + 1), CK.sample_steps(
                seed, i, n_iter, tr["maxiters"], wl["replays_per_fit"]))
            n0, t1 = sum(hooks.steps), time.perf_counter()
            fitted = _fit(bt, cell, M, _fit_seed(seed, i + 1), device)
            hooks.end_fit()
            failed += not _finite(fitted)
            fits.append(sum(hooks.steps) - n0)
            walls.append(time.perf_counter() - t1)
            del fitted
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if trace:
            tracing.disable()
            program_spans = tracing.take()
        hooks.uninstall()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # the count is the reference's model's: of no use where the program ran
    # another model or a path that the reference does not declare
    count = load_count(root, cfg["reference"]) if declared and not gaps \
        else None
    # a traced run's readings leave out the profiler's own start and stop
    run_rec = Run(cell=cell, K=K, N=N, G=G, C=tr.get("n_chains", 1),
                  count=count, learning=learning, path=path, trace=trace,
                  setup_s=setup_s,
                  window_s=window_s - hooks.prof_s, chain_iters=sum(fits),
                  fits=fits,
                  steps=hooks.steps, spans=hooks.spans, stretch=None,
                  kernel_ms={}, program_spans=program_spans)
    if trace:
        _trace_readings(torch, hooks, run_rec)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check, once the window has closed and its state is freed
    t_check = time.perf_counter()
    data = torch.as_tensor(M, device=device)
    hp = ref.hyperpriors(N, float(np.asarray(M, np.float32).mean()))
    for cap in hooks.captures:
        cap["in"]["temperature"] = float(cap["in"]["temperature"])
    args = (ref, data, hp, hooks.captures, hooks.starts, path, N, sbfi,
            learning)
    got = CK.mismatch(*args)
    check_s = time.perf_counter() - t_check
    if keep is not None:
        keep.update(args=args, got=got, spec=spec, run=run_rec)
    limits = wl["limits"]
    checks = {"mismatch_share": {"value": got["mismatch_share"],
                                 "limit": limits["mismatch_share"]}}
    correct = (got["mismatch_share"] <= limits["mismatch_share"]
               and got["steps"] >= len(fits) and got["starts"] == len(fits)
               and failed == 0 and path == tr["path"] and not gaps)

    metrics = {}
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    for m in wanted:
        v = read_metric(load_reader(root, m["name"]), run_rec)
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
    lines = gaps + ([] if declared else [
        f"path {path}: not declared by the reference {cfg['reference']} "
        f"(it declares {', '.join(ref.STEPS)}); nothing replayed"])
    lines += [f"worst: {got['worst']}; steps compared {got['steps']}, starts "
              f"{got['starts']}, fits {len(fits)}, failed {failed}; path "
              f"{path} (the cell's: {tr['path']})",
              "fit seconds: " + " ".join(f"{w:.3f}" for w in walls)
              + f"; window {window_s:.3f} s, profiler {hooks.prof_s:.3f} "
              f"s, check {check_s:.3f} s"]
    if trace:
        lines.append("span seconds: " + ", ".join(
            f"{k} {sum(v):.3f} ({len(v)})" for k, v in hooks.spans.items())
            + "; kernel ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in run_rec.kernel_ms.items()))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return res, lines


def _trace_readings(torch, hooks: Hooks, run_rec: Run):
    """The times of the timed groups whose calls were all captured, then
    the profiled stretch's events and summary (read after the timing, so
    that host-issued calls are not timed beside a large trace in memory)."""
    reps = run_rec.cell["workload"].get("kernel_reps", 20)
    for name, calls in hooks.timed.items():
        got = [hooks.kernel_calls.get(c) for c in calls]
        if None in got:
            continue

        def group(got=got):
            for fn, a, k in got:
                fn(*a, **k)
        run_rec.kernel_ms[name] = time_ms(torch, group, reps)
    hooks.kernel_calls = {}
    if hooks.stretch is not None:
        st = hooks.stretch
        run_rec.events = PR.read_trace(st.pop("prof"))
        run_rec.stretch_ns = st.pop("ns")
        run_rec.stretch = st | PR.summarize(run_rec.events)
