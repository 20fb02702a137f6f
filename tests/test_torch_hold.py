"""The port's hold against the JAX package (``marlnav_tpu_torch/scripts/
hold.py``) on the CPU: the JAX package's initial weights it carries, its
Mann-Whitney U test, and every check at a toy size.

Run as a script, this file writes ``marlnav_tpu_torch/scripts/
jax_init_weights.npz`` anew from the JAX package
(``python tests/test_torch_hold.py``).
"""

import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import make_mappo as j_make_mappo
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu_torch.models.networks import flat_params
from marlnav_tpu_torch.scripts import curriculum as cur
from marlnav_tpu_torch.scripts import hold
from marlnav_tpu_torch.scripts import sweep as swp
from test_torch_fused_collect import assert_buffers_match, run_both


def jax_initial_params(seeds):
    """``{seed: {"actor": flat, "critic": flat}}`` of the JAX curriculum's
    ``mappo.init(jax.random.PRNGKey(seed))`` (scripts/curriculum.py:283)
    at its widths (obs 12, hidden 50, 3 agents), in the ``.npz`` key
    format.  The parameters do not depend on the env count, so 8 envs."""
    p, t = 8, 20
    cfg = JMAPPOConfig(num_parallel=p, buffer_len=t, batch_size=t,
                       num_epochs=10, num_total=t * p, lr=3e-4, gamma=0.99,
                       epsilon=0.2, use_gae=True, faithful=False,
                       fused_updates=True)
    env = j_make_env(JEnvParams(num_parallel=p, staggered_resets=True),
                     JTriangleInit(num_parallel=p, num_obstacles=3), None)
    mappo = j_make_mappo(cfg, env, JNormalizerConfig(), JScalerConfig())
    out = {}
    for seed in seeds:
        ts, _ = mappo.init(jax.random.PRNGKey(seed))
        out[seed] = {
            net: {f"{layer}.{leaf}": np.asarray(getattr(dense, leaf))
                  for layer, dense in params._asdict().items()
                  for leaf in ("w", "b")}
            for net, params in (("actor", ts.actor), ("critic", ts.critic))}
    return out


def write_jax_init(path=hold.JAX_INIT):
    """The ``.npz`` ``hold.load_jax_init`` reads: every seed of
    ``hold.SEEDS``."""
    arrays = {f"{seed}/{net}/{key}": arr
              for seed, nets in jax_initial_params(hold.SEEDS).items()
              for net, flat in nets.items()
              for key, arr in flat.items()}
    np.savez(path, **arrays)


def test_jax_init_file_equals_jax_init():
    """The committed initial weights of each of the 16 seeds equal the JAX
    package's ``init(PRNGKey(s))`` within 1e-6, and load into the port's
    networks through ``load_flat_params`` as they stand in the file."""
    table = hold.load_jax_init()
    assert sorted(table) == sorted(hold.SEEDS)
    for seed, want in jax_initial_params(hold.SEEDS).items():
        for net in ("actor", "critic"):
            assert sorted(table[seed][net]) == sorted(want[net])
            for key, arr in want[net].items():
                np.testing.assert_allclose(table[seed][net][key], arr,
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{seed} {net} {key}")


def test_jax_initial_weights_replace_the_ports_draw():
    """Inside ``jax_initial_weights`` the curriculum's ``_start`` returns
    networks holding the file's weights for the seed; outside it, the
    port's own draw again."""
    table = hold.load_jax_init()
    ep = cur.EnvParams(num_parallel=8, staggered_resets=True)
    icfg = cur.TriangleInitConfig(num_parallel=8, num_obstacles=3)
    mappo, _ = cur.stage_functions(cur.build_cfg(8, 8), ep, icfg, "cpu")
    with hold.jax_initial_weights(table):
        ts, _ = cur._start(mappo, 13, torch.device("cpu"))
    for net, module in (("actor", ts.actor), ("critic", ts.critic)):
        for key, arr in flat_params(module).items():
            np.testing.assert_array_equal(arr, table[13][net][key])
    own, _ = cur._start(mappo, 13, torch.device("cpu"))
    assert not np.array_equal(flat_params(own.actor)["fc1.w"],
                              table[13]["actor"]["fc1.w"])


def test_mann_whitney_by_hand_with_ties():
    """x = (1, 2, 2, 3), y = (2, 3, 4, 5).  Ranks of the 8 values: 1 -> 1,
    the three 2s -> 3, the two 3s -> 5.5, 4 -> 7, 5 -> 8; x's rank sum
    12.5, U = 12.5 - 4 * 5 / 2 = 2.5.  Ties (3 and 2 values): sum of t^3 -
    t = 24 + 6 = 30; var = 4 * 4 / 12 * (9 - 30 / 56) = 11.2857...;
    z = (13.5 - 8 - 0.5) / sqrt(var) = 1.48835; p = erfc(z / sqrt 2)."""
    res = hold.mann_whitney([1, 2, 2, 3], [2, 3, 4, 5])
    var = 16 / 12 * (9 - 30 / 56)
    assert res["u"] == 2.5
    assert var == pytest.approx(11.285714285714286)
    z = 5.0 / math.sqrt(var)
    assert z == pytest.approx(1.488351, abs=1e-6)
    assert res["p"] == pytest.approx(math.erfc(z / math.sqrt(2.0)),
                                     rel=1e-12)
    assert res["p"] == pytest.approx(0.136658, abs=1e-6)
    # Every value equal: no evidence either way.
    assert hold.mann_whitney([0, 0], [0, 0, 0])["p"] == 1.0


@pytest.mark.parametrize("case", ["shares", "ties", "shifted"])
def test_mann_whitney_matches_scipy(case):
    """Against ``scipy.stats.mannwhitneyu(..., method="asymptotic")`` on
    samples like the hold's: shares with zeros tied, values rounded to 3
    places (var_bias_mean), a clear shift."""
    stats = pytest.importorskip("scipy.stats")
    rng = np.random.default_rng({"shares": 1, "ties": 2, "shifted": 3}[case])
    if case == "shares":
        x = np.where(rng.random(16) < 0.25, 0.0, rng.lognormal(-6, 2, 16))
        y = np.where(rng.random(16) < 0.25, 0.0, rng.lognormal(-5, 2, 16))
    elif case == "ties":
        x = np.round(rng.normal(-0.27, 0.07, 16), 3)
        y = np.round(rng.normal(-0.25, 0.07, 14), 2)
    else:
        x, y = rng.normal(0, 1, 16), rng.normal(2, 1, 16)
    res = hold.mann_whitney(x, y)
    want = stats.mannwhitneyu(x, y, alternative="two-sided",
                              method="asymptotic")
    assert res["u"] == float(want.statistic)
    assert res["p"] == pytest.approx(float(want.pvalue), rel=1e-9)


def _finite(x):
    """Every number in a JSON-like tree is finite."""
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def test_hold_all_checks_at_a_toy_size(tmp_path):
    """``hold --check all --device cpu`` at 2 seeds, 64 envs x 20 steps
    (h42: the state's 4,096 envs), 2 repeats a stage, 2 stages of H42 and
    the quick sweep at 2 repeats a cell (and at one more seed): every
    check's fields written, finite, each verdict a bool, the cuts
    named."""
    out = str(tmp_path / "hold")
    res = hold.main(["--device", "cpu", "--seeds", "2,42",
                     "--repeats-per-stage", "2", "--stages", "2", "--grid",
                     "quick", "--sweep-repeats", "2", "--sweep-seeds", "3",
                     "--out", out], p=64, t=20)
    with open(os.path.join(out, "hold.json")) as fh:
        written = json.load(fh)
    assert written == json.loads(json.dumps(res))
    assert all(res["cuts"].values())
    assert _finite(written)
    for check in hold.CHECKS:
        assert isinstance(res[check]["passed"], bool), check
    for check in ("ignition", "ignition-jax-init"):
        r = res[check]
        assert sorted(r["port"]) == [2, 42] and len(r["jax"]) == 16
        for rec in r["port"].values():
            assert set(hold.STAGE_FIELDS) <= set(rec)
        for group in ("all", "without_5_42"):
            t_ = r["tests"][group]
            assert 0.0 <= t_["tar_share"]["p"] <= 1.0
            assert 0.0 <= t_["var_bias_mean"]["p"] <= 1.0
        assert r["tests"]["without_5_42"]["seeds"] == 1
        assert r["tests"]["without_5_42"]["jax_seeds"] == 14
        assert r["jax"][42]["tar_share"] == 0.2361
    # Same seeds and env streams, other initial weights.
    assert res["ignition"]["port"][2] != res["ignition-jax-init"]["port"][2]
    stages = res["h42"]["stages"]
    assert [s["stage"] for s in stages] == [32, 33]
    assert stages[0]["jax_tar_share"] == 0.0876
    assert all(s["radius"] == 30.0 and s["mean_tar"] >= 0 for s in stages)
    cells = res["sweep"]["cells"]
    assert len(cells) == 2 and res["sweep"]["jax_order_by_risk"] == [0.0,
                                                                      250.0]
    assert {c["jax_mean_rew_last"] for c in cells} == {1885.53357421875,
                                                      1026.8898699951171}
    assert all(sorted(c["other_seeds"]) == [3] for c in cells)


@pytest.mark.parametrize("cell", swp.MAIN, ids=lambda c: "-".join(
    f"{v:g}" for v in c))
def test_sweep_cells_collect_as_jax(cell):
    """The sweep check's bisect on the CPU: each cell's reward factors
    (``sweep --grid main``: risk, heading, soft; target 500; staggered
    resets) through one step of an untamed actor, the port's collect
    against the JAX package's kernel in interpret mode on the same weights,
    state and uniforms: every buffer field (the returns are the rewards
    here), the final rows and the episode counts, at
    test_torch_fused_collect's tolerances.  (With GAE the bootstrap value
    reads the final state's observations, whose angles flip across +-pi
    for headings a full turn of steering leaves reversed, in either
    package: test_torch_fused_collect holds that path on a tamed actor.)"""
    risk, heading, ent, soft = cell
    j, t = run_both(1, tame=False, ent_const=ent,
                    env=dict(risk_factor=risk, heading_factor=heading,
                             soft_factor=soft, target_factor=500.0,
                             staggered_resets=True))
    assert_buffers_match(j, t)


def test_autograd_updates_route_the_programs_around_the_kernels():
    """``--updates autograd``: inside ``autograd_updates`` the curriculum's
    and the sweep's configurations train without the fused update kernels;
    outside it, with them again."""
    from marlnav_tpu_torch.__main__ import build_parser

    args = build_parser().parse_args(["--fused-updates"])
    with hold.autograd_updates():
        assert not cur.build_cfg(8, 8).fused_updates
        assert not swp.resolve_run_config(args).model.fused_updates
    assert cur.build_cfg(8, 8).fused_updates
    assert swp.resolve_run_config(args).model.fused_updates


def test_hold_raises_without_a_card(tmp_path, monkeypatch):
    """``--device`` defaults to cuda, which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hold.main(["--check", "sweep", "--out", str(tmp_path)])


if __name__ == "__main__":
    write_jax_init()
    print("wrote", hold.JAX_INIT, file=sys.stderr)
