"""The serving host that every loop of the benchmark drives, and the window
that records what the loop timed.

A traffic file (``portbench/traffic/<mix>.json``) names a loop and sizes it
(batch, prompt length, cache length, horizon, probes, steps between
operations...).  The loop is ``portbench/loops/<loop>.py``, found by name;
it drives the port's ``Engine``, ``scrutinize`` and ``CheckpointManager``
over a :class:`Host`.  Every loop has the same shape: set-up (weights and
prompts from the seed, prefill, whatever state the loop starts from, one
untimed round of its operation so that every kernel is built and every
shape warm), then a window of ``seconds`` in which the host repeats its
operation under :meth:`Window.op`, each timed on the host's clock from its
call until the card has synchronized.  The window closes after the
operation that crosses its end.  What the judge needs afterwards is kept,
and the program's own state is freed before the reference runs.

The weights are the benchmark's, not the program's: one float32 draw on the
card from the seed for the whole tree, laid out as the program's parameter
tree names it, scaled leaf by leaf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import resource
import time
from typing import Any, Callable, Dict, List, Optional

import torch

# the chunk K3 compares (``CheckpointManager``'s default delta_chunk_bytes)
DELTA_CHUNK_BYTES = 2048

# the caching allocator's counters an operation is charged with
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A sample of fixed size drawn from the seed out of a stream of unknown
    length, plus the stream's last item (the longest-running state)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.reset()

    def reset(self) -> None:
        self.items: List[Any] = []
        self.seen = 0
        self.last: Any = None

    def offer(self, item) -> None:
        self.seen += 1
        self.last = item
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item

    def sample(self) -> List[Any]:
        out = list(self.items)
        if self.last is not None and all(x is not self.last for x in out):
            out.append(self.last)
        return out


def flatten_numbers(prefix: str, tree) -> Dict[str, float]:
    """Every number in a nested dict, named by its path: ``save.blocked_s``,
    ``save.stages.write_s``."""
    out: Dict[str, float] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_numbers(f"{prefix}.{k}", v))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        out[prefix] = float(tree)
    return out


class Op:
    """One timed operation; its loop may rename it once it knows what it
    was (a save that turned out to write a base)."""

    def __init__(self, name: str):
        self.name = name
        self.program: Dict[str, float] = {}

    def record(self, prefix: str, stats) -> None:
        """Every number of the program's ``stats`` for this operation."""
        self.program.update(flatten_numbers(prefix, stats))


@dataclasses.dataclass
class Window:
    """What the measured window recorded, each table by name:

    - ``ops``: seconds of each timed operation;
    - ``program``: each number the program reported for an operation (its
      stats by path, its ``repro_torch.obs`` spans as ``span.<name>``
      seconds, where the traced run turns them on);
    - ``work``: operations and bytes from shapes (``metrics/arith.py``);
    - ``host``: what the host did in each operation (context switches, CPU
      seconds of the process and of its main thread, page faults, the
      garbage collector's seconds and full collections, the allocator's
      counters), for finding outliers;
    - ``counts``: numbers of the run as a whole.
    """
    seconds: float
    ops: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    program: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    work: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    host: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    started: Optional[float] = None
    on_open: Optional[Callable[[], None]] = None

    def add(self, table: str, name: str, value: float) -> None:
        getattr(self, table).setdefault(name, []).append(float(value))

    def open(self) -> None:
        if self.on_open is not None:
            self.on_open()
        self.started = time.perf_counter()

    def is_open(self) -> bool:
        return time.perf_counter() - self.started < self.seconds

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span the traced run names the card's idle gaps by."""
        with torch.profiler.record_function(name):
            yield

    @contextlib.contextmanager
    def op(self, name: str, device: torch.device):
        """Time the body from its call until the card has synchronized.
        Before the window opens (a warm round) nothing is recorded."""
        from repro_torch import obs
        o = Op(name)
        sync(device)
        buf = obs.get_obs().buffer
        mark = buf.mark()
        before = _host_counters(device)
        t0 = time.perf_counter()
        with self.span(name):
            yield o
            sync(device)
        dt = time.perf_counter() - t0
        if self.started is None:
            return
        self.add("ops", o.name, dt)
        for k, v in o.program.items():
            self.add("program", k, v)
        for ev in buf.events_since(mark):
            if ev.get("ph") == "X" and "dur" in ev:
                self.add("program", f"span.{ev['name']}", ev["dur"] / 1e6)
        after = _host_counters(device)
        self.host.setdefault(o.name, []).append(
            dict({k: after[k] - before[k] for k in after}, s=dt))


class _GcClock:
    """Seconds the interpreter's cyclic garbage collector ran, and its full
    (oldest-generation) collections, since this module was imported."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.s, self.full = 0.0, 0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.s += time.perf_counter() - self.t0
            self.full += info.get("generation") == 2
            self.t0 = None


GC_CLOCK = _GcClock()
gc.callbacks.append(GC_CLOCK)


def _host_counters(device: torch.device) -> Dict[str, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime,
           "main_cpu_s": time.thread_time(), "nivcsw": ru.ru_nivcsw,
           "nvcsw": ru.ru_nvcsw, "minflt": ru.ru_minflt,
           "gc_s": GC_CLOCK.s, "gc_full": GC_CLOCK.full}
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out.update({k: stats.get(k, 0) for k in ALLOC_COUNTERS})
    return out


class Host:
    """The serving host of one run: the benchmark's weights and prompts, the
    port's engine over them, the tokens it served."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, port_cfg=None):
        from repro_torch import Engine, get_config
        self.config, self.traffic, self.device = config, traffic, device
        self.cfg = port_cfg if port_cfg is not None else \
            get_config(config["port_arch"])
        check_config(self.cfg, config)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.rng = random.Random(int(seed))
        self.params, self.named = make_params(self.cfg, self.gen, device)
        B, T = traffic["batch"], traffic["prompt_len"]
        self.prompts = torch.randint(0, self.cfg.vocab, (B, T),
                                     generator=self.gen, device=device,
                                     dtype=torch.int32)
        self.max_len = int(traffic["max_len"])
        self.engine = Engine(self.cfg, self.params, self.max_len,
                             device=device)
        self.served: List[torch.Tensor] = []    # the first episode's tokens
        self.episodes = 0
        self.pos = 0
        self.state = None

    def start(self) -> None:
        """Prefill the prompts: a new episode."""
        self.state = self.engine.start({"tokens": self.prompts})
        self.pos = self.prompts.shape[1]
        self.episodes += 1
        if self.episodes == 1:
            self.served.append(self.state["tokens"][:, 0])

    def decode(self, steps: int) -> None:
        for _ in range(steps):
            self.state, toks = self.engine.step(self.state)
            self.pos += 1
            if self.episodes == 1:
                self.served.append(toks)

    def room(self, steps: int, after: int = 0) -> None:
        """Start a new episode if ``steps`` decode steps and ``after`` more
        positions would pass the cache."""
        if self.pos + steps + after > self.max_len:
            self.start()

    def scrutinize(self, probe_pos: int):
        from repro_torch import ScrutinyConfig, scrutinize
        tr = self.traffic
        probe = dict(self.state, pos=torch.tensor(
            probe_pos, dtype=torch.int32, device=self.device))
        return scrutinize(self.engine.resume_fn(tr["horizon"]), probe,
                          config=ScrutinyConfig(probes=tr["probes"]),
                          device=self.device)

    def cache_leaves(self) -> Dict[str, torch.Tensor]:
        from repro_torch import _tree
        return {n: t for n, t in _tree.flatten_with_names(self.state)[0]
                if n.startswith("cache/")}

    def state_bytes(self) -> int:
        from repro_torch import _tree
        return sum(t.nbytes for t in _tree.leaves(self.state))

    def served_tokens(self) -> torch.Tensor:
        return torch.stack(self.served, dim=1)

    def free_program(self) -> None:
        """Drop the engine and its state; the weights and prompts stay."""
        self.engine = None
        self.state = None


def check_config(cfg, config: dict) -> None:
    """The port's configuration is the file's, as it is run."""
    pairs = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
             "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads",
             "resolved_head_dim": "head_dim", "vocab": "vocab_size",
             "tie_embeddings": "tie_word_embeddings",
             "rope_theta": "rope_theta", "param_dtype": "param_dtype",
             "dtype": "compute_dtype"}
    if cfg.moe is not None:
        pairs.update({"moe.num_experts": "num_experts",
                      "moe.top_k": "num_experts_per_tok",
                      "moe.d_expert": "intermediate_size"})
    else:
        pairs["d_ff"] = "intermediate_size"
    for attr, key in pairs.items():
        got = cfg
        for part in attr.split("."):
            got = getattr(got, part)
        if got != config[key]:
            raise ValueError(f"{config['name']}: the port runs {attr}={got!r}"
                             f", the configuration file says {key}="
                             f"{config[key]!r}")


def make_params(cfg, gen: torch.Generator, device: torch.device):
    """The parameter tree of ``cfg`` as views of one float32 draw from
    ``gen``: N(0, 1) / sqrt(fan_in) for matrices (fan_in: the second-to-last
    axis), N(0, 0.02) for the embedding and the LM head, norm offsets 0.
    Returns (tree, {name: leaf})."""
    from repro_torch import _tree
    from repro_torch.models import init_params
    named, treedef = _tree.flatten_with_names(
        init_params(cfg, None, device="meta"))
    total = sum(t.numel() for _, t in named)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    leaves, off = [], 0
    for name, meta in named:
        leaf = flat[off:off + meta.numel()].view(meta.shape)
        off += meta.numel()
        last = name.split("/")[-1]
        if last in ("scale", "bias"):
            leaf.zero_()
        elif last in ("embed", "lm_head"):
            leaf.mul_(0.02)
        else:
            leaf.mul_(meta.shape[-2] ** -0.5)
        leaves.append(leaf)
    return (_tree.unflatten(treedef, leaves),
            {n: t for (n, _), t in zip(named, leaves)})
