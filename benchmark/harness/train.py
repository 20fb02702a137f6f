"""The ``train`` traffic: blocks of training repeats through the port's
block runner (``marlnav_tpu_torch.train._Blocks``), as ``train.train``
and the curriculum's ``run_repeats`` drive it.

Set-up builds the cell's objects once (``make_env``, ``make_mappo``,
``mappo.init``, ``make_fused_collect``), hands them the seed's weights and
env rows, runs the eager first block and the first graphed block (its
capture and one replay: ``_Blocks`` requires the eager block before a
capture), and reads that graphed block's first three repeats for the
check.  The window then runs graphed blocks, each followed by the one read
of its rows, until ``--seconds`` have passed.

The check needs the state at the start of each compared repeat, which a
graph replay keeps inside.  The collect callable the runner is given
first copies the rows, the weights and Adam's moments and steps into
slot ``seed mod K`` of a ring (K the block's repeats), in the graph and
so in every replay.  The traced run measures those copies' kernels apart
(``harness_work``), so that the glue metrics leave them out.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import inputs

PORT_ROWS = ("px", "py", "dx", "dy", "sp", "obx", "oby", "tg", "misc")


class StateRing:
    """A ring of K copies of the training state, one a repeat."""

    def __init__(self, k: int):
        self.k, self.enabled = k, False
        self.layout = self.ring = None
        self.zeros = {}

    def _parts(self, ts, rows):
        parts = [(("rows", n), x) for n, x in zip(PORT_ROWS, rows.fields())]
        for net, mod, opt in (("actor", ts.actor, ts.actor_opt),
                              ("critic", ts.critic, ts.critic_opt)):
            for name, p in mod.named_parameters():
                st = opt.state.get(p, {})
                parts.append(((net, name), p.detach()))
                for part, key in (("_m", "exp_avg"), ("_v", "exp_avg_sq"),
                                  ("_t", "step")):
                    x = st.get(key)
                    if x is None:
                        # An optimizer that never stepped has no state:
                        # zeros, made once.
                        if (net + part, name) not in self.zeros:
                            self.zeros[net + part, name] = p.new_zeros(
                                () if key == "step" else p.shape)
                        x = self.zeros[net + part, name]
                    parts.append(((net + part, name), x))
        return parts

    def prepare(self, ts, rows) -> None:
        """Allocate the ring (outside any capture) and start recording."""
        parts = self._parts(ts, rows)
        self.layout = [(key, tuple(x.shape)) for key, x in parts]
        n = sum(x.numel() for _, x in parts)
        self.ring = torch.zeros((self.k, n), device=rows.px.device)
        self.enabled = True

    def record(self, ts, rows, seed: torch.Tensor) -> None:
        if not self.enabled:
            return
        with torch.profiler.record_function("bench.ring"):
            parts = self._parts(ts, rows)
            flat = torch.cat([x.reshape(-1).to(torch.float32)
                              for _, x in parts])
            slot = torch.remainder(seed, self.k).to(torch.int64).reshape(1)
            self.ring.index_copy_(0, slot, flat[None])

    def unpack(self, flat: torch.Tensor) -> dict:
        out, start = {}, 0
        for (group, name), shape in self.layout:
            n = 1
            for s in shape:
                n *= s
            out.setdefault(group, {})[name] = flat[start:start + n].reshape(
                shape)
            start += n
        return out


class Traffic:
    """Set-up, window, traced window and the check's inputs of a train
    cell."""

    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.traffic, self.config = cell.traffic, cell.config
        self.overrides = overrides or {}
        self.envs = self.traffic["envs"]
        self.block = self.traffic["block"]
        self.pipeline = self.traffic["pipeline"]

    # ------------------------------------------------------------------
    def setup(self):
        from marlnav_tpu_torch.algo import make_mappo
        from marlnav_tpu_torch.env import make_env
        from marlnav_tpu_torch.ops import make_fused_collect
        from marlnav_tpu_torch.ops.fused_collect import RowState
        from marlnav_tpu_torch.train import (_Blocks, tiled_route,
                                             uncollapsed_actor)
        from marlnav_tpu_torch.utils.seeding import make_generator

        dev = self.dev
        marks = [("start", time.perf_counter())]
        if dev.type == "cuda":
            from marlnav_tpu_torch.ops._build import load_libraries

            load_libraries(["fused_collect", "fused_update", "returns"])
        marks.append(("libraries", time.perf_counter()))
        ep, icfg, norm, scal, mcfg = inputs.port_configs(
            self.config, self.envs, self.overrides)
        self.mcfg, self.ep, self.icfg = mcfg, ep, icfg
        mappo = make_mappo(mcfg, make_env(ep, icfg, dev), norm, scal,
                           uncollapsed_actor(mcfg, True),
                           tiled_route(mcfg, True))
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        weights = inputs.initial_weights(
            gen, inputs.network_shapes(self.config, self.overrides), dev)
        rows = inputs.initial_rows(gen, self.config, self.envs, dev)
        ts, _ = mappo.init(make_generator(self.seed, dev))
        inputs.load_weights(ts.actor, weights["actor"])
        inputs.load_weights(ts.critic, weights["critic"])
        self.ts = ts
        fc = make_fused_collect(mcfg, ep, icfg, norm, scal)
        self.fc = fc
        self.base_seed = (self.seed * 1_000_003) % (1 << 30)
        seeds = torch.zeros(self.block, dtype=torch.int32, device=dev)
        offsets = torch.arange(self.block, dtype=torch.int32, device=dev)
        self.ring = StateRing(self.block)
        ring = self.ring

        def collect_fn(ts_, rows_, i):
            ring.record(ts_, rows_, seeds[i])
            return fc(ts_, rows_, seeds[i])

        self.blocks = _Blocks(mappo, ts, None, collect_fn, seeds, offsets,
                              self.base_seed, self.block, self.pipeline)
        self.state = RowState(*(rows[k] for k in PORT_ROWS))
        self.n_losses = mcfg.num_epochs * mcfg.num_minibatches
        self.repeat = 0
        marks.append(("build", time.perf_counter()))
        # The eager first block, then the first graphed one: its first
        # three repeats are the check's.
        self.run_block(eager=True)
        marks.append(("eager_block", time.perf_counter()))
        self.ring.prepare(self.ts, self.state)
        first = self.repeat
        rows_out = self.run_block()
        marks.append(("graphed_block", time.perf_counter()))
        self.setup_phases = {b[0]: b[1] - a[1]
                             for a, b in zip(marks, marks[1:])}
        self.compared = {"first": first, "rows": rows_out,
                         "ring": self.ring.ring.clone(),
                         "base_seed": self.base_seed}
        self.sync()

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run_block(self, eager: bool = False, spans=None):
        """One block: the runner's call and the one read of its rows,
        which it returns on the host.  ``spans`` collects the host's
        seconds in the runner's call."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.block"):
            if eager or self.dev.type != "cuda":
                self.state, out = self.blocks.eager(self.state, self.repeat,
                                                    self.block)
            else:
                self.state, out = self.blocks.graphed(self.state,
                                                      self.repeat)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.read"):
            rows = out.cpu().numpy()
        if spans is not None:
            spans.append(t1 - t0)
        self.repeat += self.block
        return rows

    # ------------------------------------------------------------------
    def window(self, seconds: float):
        """Blocks until ``seconds`` have passed; returns the window's
        numbers: env-steps/s from the first enqueue to the last read."""
        import numpy as np

        spans, n_blocks, bad = [], 0, 0
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            rows = self.run_block(spans=spans)
            t_end = time.perf_counter()
            n_blocks += 1
            bad += int((~np.isfinite(rows)).any(axis=1).sum())
        repeats = n_blocks * self.block
        steps = repeats * self.envs * self.mcfg.buffer_len
        return {"train_env_steps_per_s": steps / (t_end - t0),
                "attempted": repeats, "failed": bad, "host_spans": spans}

    def traced(self, blocks: int, sync):
        """``blocks`` blocks under the profiler: ``(profiler output,
        host spans, repeats)``."""
        from benchmark.harness.trace import traced

        spans = []
        with traced(sync) as out:
            for _ in range(blocks):
                self.run_block(spans=spans)
        return out, spans, blocks * self.block

    def after_trace(self, ctx, on_card: bool) -> dict:
        """Complete the traced window's reading on the card: the collect
        kernel's seconds by CUDA events where the profiler did not list it
        (added to the busy time), and the state ring's kernels a repeat,
        which the glue metrics leave out.  Returns notes for the result."""
        notes = {"collect_time_source": "profiler"}
        if not on_card:
            return notes
        if ctx.work.kernels("fused_collect")[0] == 0:
            ctx.collect_s = self.collect_seconds()
            ctx.work.busy_s += ctx.collect_s * ctx.units
            notes["collect_time_source"] = "cuda_events"
        ctx.harness_kernels, ctx.harness_s = self.harness_work()
        notes["ring_kernels_per_repeat"] = ctx.harness_kernels
        return notes

    def collect_seconds(self, launches: int = 5) -> float:
        """The collect kernel's seconds a launch at the cell's shape, by
        CUDA events over ``launches`` launches of its own."""
        seed = torch.full((), self.base_seed, dtype=torch.int32,
                          device=self.dev)
        self.fc.run_kernel(self.ts, self.state, seed)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        self.sync()
        start.record()
        for _ in range(launches):
            self.fc.run_kernel(self.ts, self.state, seed)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / launches

    def harness_work(self, launches: int = 5):
        """``(kernels, seconds)`` a repeat of the state ring's copies, the
        check's own work inside the graph: the same copies run eagerly,
        ``launches`` times under the profiler (the ring is the check's
        only after set-up, which cloned it)."""
        from benchmark.harness.trace import device_work, traced

        seed = torch.full((), self.base_seed, dtype=torch.int32,
                          device=self.dev)
        self.ring.record(self.ts, self.state, seed)
        with traced(self.sync) as out:
            for _ in range(launches):
                self.ring.record(self.ts, self.state, seed)
        work = device_work(out["prof"], out["window_s"])
        return (sum(c for _, c, _ in work.table) / launches,
                sum(sec for _, _, sec in work.table) / launches)

    def shapes(self) -> dict:
        m = self.mcfg
        size = m.batch_size
        if m.faithful and size >= m.buffer_len:
            size = m.buffer_len - 1
        return {"envs": self.envs, "steps": m.buffer_len,
                "minibatch_steps": size, "agents": m.num_agents,
                "obs": m.obs_size, "hidden": m.hidden_size,
                "obstacles": self.ep.num_obstacles,
                "actor_epochs": m.num_epochs, "critic_epochs": m.num_epochs}

    def release(self):
        """Free the program's state; keep what the check reads."""
        keep = self.compared
        keep["layout"] = self.ring.layout
        for name in ("blocks", "ts", "fc", "state"):
            setattr(self, name, None)
        return keep

    def n_draws(self) -> int:
        o = self.config["env"]["num_obstacles"]
        return 6 + 2 * o + (9 if self.config["init"]["noisy_ags"] else 0)

    def reference_model(self) -> dict:
        return dict(self.config["model"], **self.overrides)


def set_up(name: str, seed: int, device, sizes=None):
    """A train cell's set-up alone, for the looks that follow its
    compared repeats: ``(traffic, keep)``, the program's state released.
    ``sizes`` as ``runner.run_cell`` takes them."""
    from benchmark.harness import spec

    cell = spec.find_cell(name)
    overrides = None
    if sizes:
        cell.traffic.update(sizes.get("traffic", {}))
        overrides = sizes.get("model")
    traffic = Traffic(cell, seed, torch.device(device), overrides)
    traffic.setup()
    return traffic, traffic.release()


def compared_repeats(traffic: Traffic, keep: dict):
    """For each compared repeat (the first graphed block's first three):
    its index in that block, the kernel seed, and the program's state at
    its start and at its end, each as ``StateRing.unpack`` gives it."""
    ring = StateRing(traffic.block)
    ring.layout = keep["layout"]
    k, first, base = traffic.block, keep["first"], keep["base_seed"]
    for i in range(3):
        r = first + i
        yield (i, base + r, ring.unpack(keep["ring"][(base + r) % k]),
               ring.unpack(keep["ring"][(base + r + 1) % k]))


def reference_repeat(traffic: Traffic, start: dict, seed: int, uniforms_fn,
                     **kwargs) -> dict:
    """The reference's repeat from the program's state ``start`` on the
    kernel seed's uniforms (``train_repeat``'s ``kwargs``)."""
    from benchmark.reference.env_step import EnvStep
    from benchmark.reference.mappo import train_repeat

    cfg, model = traffic.config, traffic.reference_model()
    step = EnvStep(cfg["env"], cfg["init"], cfg["normalizer"], cfg["scaler"])
    adam = {net: {n: (start[net + "_m"][n], start[net + "_v"][n],
                      start[net + "_t"][n]) for n in start[net]}
            for net in ("actor", "critic")}
    uniforms = uniforms_fn(seed, traffic.envs, model["buffer_len"],
                           traffic.n_draws(), start["rows"]["px"].device)
    return train_repeat(model, cfg["normalizer"], step, start["rows"],
                        start["actor"], start["critic"], adam, uniforms,
                        **kwargs)


def check(traffic: Traffic, keep: dict, uniforms_fn) -> dict:
    """The compared numbers of the first graphed block's first three
    repeats, each followed by the reference from the program's state at
    its start.  ``uniforms_fn(seed, envs, steps, n_draws, device)`` gives
    the collect's uniforms."""
    from benchmark.reference import compare

    readings = []
    for i, seed, start, end in compared_repeats(traffic, keep):
        ref = reference_repeat(traffic, start, seed, uniforms_fn)
        readings.append(compare.train_numbers(keep["rows"][i], start, end,
                                              ref, traffic.n_losses))
    return compare.worst(readings)
