"""Configuration layer: typed, hashable configs for every subsystem.

The PyTorch port's own copy of ``marlnav_tpu/config.py`` (the port imports
nothing of the JAX package).  The dataclasses, their fields and defaults,
the scenario constructors and the JSON format are the same, so a run
config written by either package loads in the other.

Mirrors the reference's config layer (reference utils.py:117-305 — nested
dicts built from argparse) as frozen dataclasses.  Scenario data that the
reference hardcodes as module-level dicts (reference utils.py:17-115) lives
here as constructor functions, and can also be loaded from JSON.

All flag names and defaults match the reference CLI
(reference __main__.py:49-132) so that baseline configs are reproducible.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment parameters.

    The first block mirrors the CLI-exposed physics / reward factors
    (reference __main__.py:73-102); the second block mirrors the geometric
    constants hardcoded in the reference env (reference environment.py:55-68).
    ``num_obstacles`` is the *effective* obstacle count, i.e. the number of
    obstacles actually present in the state arrays.  (The reference silently
    reduces the obs to the actual obstacle count when the mock initializer
    provides fewer obstacles than the CLI flag — empty tensor slices vanish
    in ``torch.cat`` — so the effective count is what matters;
    reference environment.py:148-157, utils.py:48-54.)
    """

    num_parallel: int = 2
    num_agents: int = 3
    num_obstacles: int = 3
    episode_len: int = 200
    min_speed: float = 3.0
    max_speed: float = 10.0
    min_accel: float = -0.5
    max_accel: float = 0.5
    risk_factor: float = 0.0
    distance_factor: float = 0.0
    heading_factor: float = 500.0
    target_factor: float = 500.0
    soft_factor: float = 500.0
    bond_factor: float = 10.0
    # Group-convergence shaping (TPU-native extension, default OFF for
    # reference parity): POTENTIAL-BASED on the MAX-over-agents target
    # distance, phi = -max_i d_i / init_dist, per-step reward +=
    # group_soft_factor * (phi(s') - phi(s)), broadcast to every agent
    # like the group bonus.  The reference's soft_factor rewards the
    # MEAN distance, which the round-2/3 curriculum studies showed the
    # degenerate "race" exploits (one agent dives at the target while
    # the group never converges — docs/curriculum_r3.md "Honest
    # status"); the max-potential is a continuous gradient toward
    # SIMULTANEOUS convergence, the binary group bonus's missing
    # precursor signal.  Potential DIFFERENCE, not raw penalty: the raw
    # form was measured to collapse training into the suicide basin
    # (env/reward.py has the numbers).
    group_soft_factor: float = 0.0
    # Staggered resets (off for reference parity): initialize per-env step
    # counters uniformly over the episode so truncations (and the fresh
    # low-reward episode starts that follow) spread across rollout steps
    # instead of arriving in correlated waves every episode_len steps
    # (arXiv:2511.21011 "Staggered Environment Resets Improve Massively
    # Parallel On-Policy RL"; PAPERS.md).
    staggered_resets: bool = False

    # Geometric constants (reference environment.py:55-68).
    ob_risk_dist: float = 60.0
    ag_risk_dist: float = 15.0
    ob_coll_dist: float = 50.0
    ag_coll_dist: float = 5.0
    agents_min_d: float = 30.0
    agents_max_d: float = 50.0
    max_at_prop_d: float = 2.0
    max_angle_diff: float = math.pi / 8
    target_radius: float = 30.0
    cap_distance: float = 0.1
    bond_sharpness: float = 1.0
    ideal_dist: float = 40.0
    init_dist: float = 1200.0

    @property
    def obs_size(self) -> int:
        """Per-agent observation width: 2 + 2*O + 2*(A-1).

        Generalizes the reference's hardcoded ``obs_size = 12``
        (reference utils.py:164) to any agent/obstacle count.
        """
        return 2 + 2 * self.num_obstacles + 2 * (self.num_agents - 1)


# ---------------------------------------------------------------------------
# Initializers (the env's pluggable reset distribution)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TriangleInitConfig:
    """Three agents in an equilateral triangle, random obstacles.

    Values mirror the reference's ``triangle_params``
    (reference utils.py:17-33) and ``TriangleIntitializer``
    (reference utils.py:322-408).
    """

    num_parallel: int = 2
    num_obstacles: int = 3
    ags_cent_x: float = 150.0
    ags_cent_y: float = 375.0
    ags_dist: float = 40.0
    init_speed: float = 3.0
    tar_pos_x: float = 1350.0
    tar_pos_y: float = 375.0
    noisy_ags: bool = False
    ags_std: float = 0.01
    angle_range: float = math.pi / 6
    obst_min_x: float = 500.0
    obst_max_x: float = 1000.0
    obst_min_y: float = 250.0
    obst_max_y: float = 500.0


@dataclasses.dataclass(frozen=True)
class MockInitConfig:
    """Fixed constant initial state, for deterministic tests.

    Equivalent of the reference's ``MockInitializer``
    (reference utils.py:310-319).  Arrays are stored as nested tuples so the
    config stays hashable.
    """

    states: Tuple  # (P, A, 5) nested tuples
    obstacles: Tuple  # (P, O, 2)
    target: Tuple  # (P, 1, 2)


def mock_init_scenario(num: int) -> MockInitConfig:
    """The two deterministic test scenarios of the reference.

    ``num=0``: straight-line runs incl. a max-decel agent
    (reference utils.py:35-62); ``num=1``: circular orbits engineered around
    the target/obstacle (reference utils.py:64-91).
    """
    if num == 0:
        env0 = (
            (550.0, 100.0, 0.0, 1.0, 0.0),
            (750.0, 100.0, 0.0, 1.0, 0.0),
            (950.0, 100.0, 0.0, 1.0, 5.0),
        )
        return MockInitConfig(
            states=(env0, env0),
            obstacles=(((1400.0, 375.0),), ((1400.0, 375.0),)),
            target=(((1400.0, 700.0),), ((1400.0, 700.0),)),
        )
    if num == 1:
        r3 = math.sqrt(3.0)
        orbit_speed = 2.0 * 300.0 * math.sin(math.radians(0.9))
        env0 = (
            (750.0 - 300.0 / r3, 375.0, 0.0, 1.0, 3.0 / math.sin(math.pi / 3)),
            (750.0, 375.0, 0.0, 1.0, 3.0),
            (750.0 + 300.0 / r3, 375.0, 0.0, 1.0, 3.0 / math.sin(math.pi / 3)),
        )
        env1 = (
            (450.0, 675.0, 1.0, 0.0, orbit_speed),
            (750.0, 675.0, 0.0, -1.0, 6.0),
            (1050.0, 675.0, -1.0, 0.0, orbit_speed),
        )
        return MockInitConfig(
            states=(env0, env1),
            obstacles=(((900.0, 475.0),), ((750.0, 75.0),)),
            target=(((750.0, 675.0),), ((750.0, 475.0),)),
        )
    raise ValueError(f"unknown mock scenario {num}")


# ---------------------------------------------------------------------------
# Scripted action samplers (test fixtures on the main code path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConstantSamplerConfig:
    """Every agent plays [angle=0, accel=1] forever (reference utils.py:477-485)."""

    num_parallel: int = 2
    num_agents: int = 3


@dataclasses.dataclass(frozen=True)
class MockSamplerConfig:
    """Step-indexed scripted actions (reference utils.py:419-451).

    ``num=0``: constant per-agent actions including one huge decel (-100).
    ``num=1``: special half-turn first step, then constant turn rates that
    produce circular trajectories.

    ``max_step`` replicates the reference's generator exhaustion: its
    samplers yield exactly ``max_step`` action tensors and raise
    StopIteration beyond that (reference utils.py:428-448).  ``None``
    disables the bound (a total step function).
    """

    num: int = 0
    max_step: Optional[int] = None


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NormalizerConfig:
    """Per-feature [min, max] -> [-1, 1] observation bounds.

    Bounds derive from the arena size exactly as the reference builds them
    (reference utils.py:117-140).
    """

    num_agents: int = 3
    num_obstacles: int = 3
    max_x_value: float = 1500.0
    max_y_value: float = 750.0

    def bounds(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        max_dist = math.hypot(self.max_x_value, self.max_y_value)
        o, a = self.num_obstacles, self.num_agents
        min_obs = (
            [-math.pi, 0.0]
            + o * [-math.pi]
            + o * [0.0]
            + (a - 1) * [-math.pi]
            + (a - 1) * [0.0]
        )
        max_obs = (
            [math.pi, max_dist]
            + o * [math.pi]
            + o * [max_dist]
            + (a - 1) * [math.pi]
            + (a - 1) * [max_dist]
        )
        return tuple(min_obs), tuple(max_obs)


@dataclasses.dataclass(frozen=True)
class ScalerConfig:
    """[-1, 1] network actions -> physical [angle, accel] ranges
    (reference utils.py:143-152)."""

    min_accel: float = -0.5
    max_accel: float = 0.5

    def bounds(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        return (-math.pi, self.min_accel), (math.pi, self.max_accel)


# ---------------------------------------------------------------------------
# MAPPO
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    """Trainer hyperparameters (reference __main__.py:104-122, utils.py:155-191).

    ``faithful`` replicates two reference quirks for learning-curve parity
    (SURVEY.md §2.5): (a) advantages paired with log-prob ratios via a
    *tile* instead of repeat-interleave (reference models.py:285-286) and
    (b) the silent drop of the last buffer step when a minibatch reaches the
    buffer end (reference models.py:167-171).  Set ``faithful=False`` for
    the corrected semantics; ``use_gae`` additionally switches the
    return/advantage estimator from the reference's zero-at-done discounted
    returns (reference models.py:131-148) to GAE.
    """

    num_agents: int = 3
    num_parallel: int = 2
    obs_size: int = 12
    action_size: int = 2
    hidden_size: int = 50
    lr: float = 1e-3
    ent_const: float = 1e-3
    epsilon: float = 0.01
    gamma: float = 0.9
    num_total: int = 1_000_000
    buffer_len: int = 1000
    num_epochs: int = 50
    batch_size: int = 1000
    faithful: bool = True
    use_gae: bool = False
    gae_lambda: float = 0.95
    # The next three fields keep the JSON format of the JAX package's
    # MAPPOConfig.  bf16_updates rounds the update products' operands on
    # every route (algo/mappo.py); fused_updates runs the gradient kernels
    # of ops/fused_update.py.
    # float64 return accumulation (the reference's accumulator dtype).
    returns_f64: bool = False
    # bf16 matmul operands + f32 accumulation in the PPO update losses.
    bf16_updates: bool = False
    # Fused update kernels: loss + all gradients in one pass per minibatch.
    fused_updates: bool = False

    def __post_init__(self):
        # Same validation as the reference (utils.py:157-162).
        if self.batch_size > self.buffer_len:
            raise ValueError("batch_size can't be greater than buffer_len.")
        if self.num_total % (self.buffer_len * self.num_parallel) != 0:
            raise ValueError(
                "num_total should be divisible with (buffer_len * num_parallel)."
            )

    @property
    def num_repeats(self) -> int:
        return self.num_total // (self.buffer_len * self.num_parallel)

    @property
    def num_minibatches(self) -> int:
        return self.buffer_len // self.batch_size


# ---------------------------------------------------------------------------
# Animation / diagnostics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnimationConfig:
    """Renderer / reward-check parameters (reference utils.py:194-214)."""

    fig_size_x: float = 10.0
    fig_size_y: float = 5.0
    max_x_value: float = 1500.0
    max_y_value: float = 750.0
    num_agents: int = 3
    parallel_index: int = 0
    agent_index: int = 0
    sampling_style: str = "sampler"
    random: bool = False
    weights_file: Optional[str] = None
    max_step: int = 1000
    interval: int = 10
    # Actor width for policy rendering — rendering mode builds no model
    # config, so the renderer carries the -hs flag itself.
    hidden_size: int = 50


# ---------------------------------------------------------------------------
# Top-level bundle + scenario resolution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything a run needs, resolved from CLI args or JSON."""

    env: EnvParams
    init: object  # TriangleInitConfig | MockInitConfig
    sampler: object  # ConstantSamplerConfig | MockSamplerConfig | None
    model: Optional[MAPPOConfig]
    normalizer: NormalizerConfig
    scaler: ScalerConfig
    animation: AnimationConfig
    seed: Optional[int] = None
    max_step: int = 1000


def resolve_run_config(args) -> RunConfig:
    """Build a RunConfig from an argparse namespace with the reference's
    flag names (reference utils.py:217-305 ``set_*_params``).

    Scenario selection follows ``--sampler_num``: -1 = triangle init
    (+ constant sampler unless policy), 0/1 = the deterministic mock
    scenarios.  For mock scenarios the effective parallel-env and obstacle
    counts come from the mock arrays themselves (the reference would
    otherwise produce silently-empty slices; SURVEY.md §2.3).
    """
    sn = args.sampler_num
    if sn == -1:
        init = TriangleInitConfig(
            num_parallel=args.num_parallel, num_obstacles=args.num_obstacles
        )
        num_parallel = args.num_parallel
        num_obstacles = args.num_obstacles
        if getattr(args, "sampling_style", "sampler") == "policy":
            sampler = None
        else:
            sampler = ConstantSamplerConfig(
                num_parallel=num_parallel, num_agents=args.num_agents
            )
    elif sn in (0, 1):
        init = mock_init_scenario(sn)
        num_parallel = len(init.states)
        num_obstacles = len(init.obstacles[0])
        sampler = MockSamplerConfig(num=sn, max_step=args.max_step)
    else:
        raise ValueError(f"sampler_num must be -1, 0 or 1, got {sn}")

    env = EnvParams(
        num_parallel=num_parallel,
        num_agents=args.num_agents,
        num_obstacles=num_obstacles,
        episode_len=args.episode_len,
        min_speed=args.min_speed,
        max_speed=args.max_speed,
        min_accel=args.min_accel,
        max_accel=args.max_accel,
        risk_factor=args.risk_factor,
        distance_factor=args.distance_factor,
        heading_factor=args.heading_factor,
        target_factor=args.target_factor,
        soft_factor=args.soft_factor,
        bond_factor=args.bond_factor,
        staggered_resets=getattr(args, "staggered_resets", False),
    )

    model = None
    if not (getattr(args, "rendering", False) or getattr(args, "reward_check", False)):
        model = MAPPOConfig(
            num_agents=args.num_agents,
            num_parallel=num_parallel,
            obs_size=env.obs_size,
            hidden_size=args.hidden_size,
            lr=args.learning_rate,
            ent_const=args.ent_const,
            epsilon=args.epsilon,
            gamma=args.gamma,
            num_total=args.num_total,
            buffer_len=args.buffer_len,
            num_epochs=args.num_epochs,
            batch_size=args.batch_size,
            faithful=not getattr(args, "fixed_semantics", False),
            use_gae=getattr(args, "use_gae", False),
            returns_f64=getattr(args, "returns_f64", False),
            bf16_updates=getattr(args, "bf16_updates", False),
            fused_updates=getattr(args, "fused_updates", False),
        )

    normalizer = NormalizerConfig(
        num_agents=args.num_agents,
        num_obstacles=num_obstacles,
        max_x_value=args.max_x_value,
        max_y_value=args.max_y_value,
    )
    scaler = ScalerConfig(min_accel=args.min_accel, max_accel=args.max_accel)
    animation = AnimationConfig(
        fig_size_x=args.fig_size_x,
        fig_size_y=args.fig_size_y,
        max_x_value=args.max_x_value,
        max_y_value=args.max_y_value,
        num_agents=args.num_agents,
        parallel_index=args.parallel_index,
        agent_index=args.agent_index,
        sampling_style=getattr(args, "sampling_style", "sampler"),
        random=getattr(args, "random", False),
        weights_file=getattr(args, "weights_file", None),
        max_step=args.max_step,
        interval=args.interval,
        hidden_size=args.hidden_size,
    )
    return RunConfig(
        env=env,
        init=init,
        sampler=sampler,
        model=model,
        normalizer=normalizer,
        scaler=scaler,
        animation=animation,
        seed=args.seed,
        max_step=args.max_step,
    )


def config_to_json(cfg: RunConfig) -> str:
    """Serialize a full run config (the params-JSON artifact the reference
    dumps per run, reference models.py:214-217)."""

    def enc(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            # Shallow: nested dataclasses re-enter enc via json's default
            # hook, so each keeps its own __type__ tag.
            d = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
            d["__type__"] = type(obj).__name__
            return d
        raise TypeError(f"not serializable: {obj!r}")

    return json.dumps(cfg, default=enc, indent=4, sort_keys=True)


_CONFIG_TYPES = {
    "EnvParams": EnvParams,
    "TriangleInitConfig": TriangleInitConfig,
    "MockInitConfig": MockInitConfig,
    "ConstantSamplerConfig": ConstantSamplerConfig,
    "MockSamplerConfig": MockSamplerConfig,
    "MAPPOConfig": MAPPOConfig,
    "NormalizerConfig": NormalizerConfig,
    "ScalerConfig": ScalerConfig,
    "AnimationConfig": AnimationConfig,
}


def _decode(obj):
    if isinstance(obj, dict) and "__type__" in obj:
        cls = _CONFIG_TYPES[obj.pop("__type__")]
        fields = {f.name for f in dataclasses.fields(cls)}

        def totuple(v):
            return tuple(totuple(x) for x in v) if isinstance(v, list) else v

        kwargs = {k: totuple(_decode(v)) if isinstance(v, list) else _decode(v)
                  for k, v in obj.items() if k in fields}
        return cls(**kwargs)
    return obj


def load_config_json(path: str) -> RunConfig:
    """Load a scenario / run config from JSON (working version of the
    reference's dead ``load_config``, utils.py:562-568)."""
    with open(os.path.expanduser(path)) as f:
        raw = json.load(f)
    raw.pop("__type__", None)
    kwargs = {k: _decode(v) for k, v in raw.items()}
    return RunConfig(**kwargs)
