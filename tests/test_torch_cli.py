"""The port's command line (`cli/main.py`), every subcommand with
`--device cpu --dtype float64` and short runs, with the assertions of
tests/test_cli.py; and the pieces it stands on against the JAX package's:
`config.load_yaml_params` field for field on every configs/*.yaml, and
`viz.plots.trace_to_arrays`, `save_trace` / `load_trace` on the same trace
arrays (equal arrays, equal files' contents)."""
import glob
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import load_yaml_params as jax_load_yaml_params
from quadrupedwholebodycontroller_tpu.sim.rollout import RolloutTrace as JaxRolloutTrace
from quadrupedwholebodycontroller_tpu.viz import plots as jplots
from quadrupedwholebodycontroller_tpu_torch.cli import main as cli
from quadrupedwholebodycontroller_tpu_torch.config import load_yaml_params
from quadrupedwholebodycontroller_tpu_torch.sim.rollout import RolloutTrace
from quadrupedwholebodycontroller_tpu_torch.viz import plots

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
CPU64 = ["--dtype", "float64", "--device", "cpu"]


@pytest.fixture(scope="module")
def standing_trace(tmp_path_factory):
    """A saved 40-step standing trace (the standing subcommand's --save)."""
    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("cli") / "t.npz")
    cli.main(["standing", "--seconds", "0.1", "--save", path] + CPU64)
    return path


def test_standing_cli(standing_trace):
    d = np.load(standing_trace)
    assert d["com_pos"].shape == (40, 3) and float(d["control_rate"]) == 400.0
    assert np.isfinite(d["tau"]).all() and d["com_pos"][:, 2].min() > 0.4


@pytest.mark.parametrize("gait", ["walk", "trot"])
def test_gait_cli(gait, capsys):
    cli.main([gait, "--seconds", "0.1"] + CPU64)
    out = capsys.readouterr().out
    assert f"{gait} 0.1s sim in" in out and "T=40 steps" in out


def test_teleop_replay_cli(tmp_path, capsys):
    stream = str(tmp_path / "cmd.csv")
    with open(stream, "w") as f:
        f.write("0.0, 0.0, 0.0, 0.0\n0.02, 0.4, 0.0, 0.0\n0.05, 0.0, 0.0, 0.0\n")
    cli.main(["teleop-replay", stream] + CPU64)
    assert "T=21 steps" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["params_controller.yaml", "params_planner.yaml"])
def test_params_yaml_cli(name, capsys):
    cli.main(["standing", "--seconds", "0.02", "--params", os.path.join(CONFIGS, name)] + CPU64)
    assert "T=8 steps" in capsys.readouterr().out


@pytest.mark.parametrize("gait", ["walk", "trot"])
def test_sweep_cli(gait, capsys):
    torch.set_num_threads(1)
    cli.main(["sweep", "--batch", "8", "--seconds", "0.06", "--gait", gait] + CPU64)
    out = capsys.readouterr().out
    assert "sweep B=8 T=24 on 1 devices" in out and "fallen=0.000" in out


def test_inspect_cli(tmp_path, capsys):
    out_png = str(tmp_path / "skel.png")
    cli.main(["inspect", "--out", out_png] + CPU64)
    out = capsys.readouterr().out
    assert "total_mass=51.6357" in out
    assert "frame LH_FOOT" in out
    assert os.path.exists(out_png)


def test_teleop_live_cli(tmp_path, monkeypatch, capsys):
    """Live teleop (the reference's teleop_gui_node.cpp): a scripted stdin
    session (one key per 100 ms tick, the command held between ticks) steers
    the robot and records a trace."""
    trace = str(tmp_path / "teleop.npz")
    monkeypatch.setattr(sys, "stdin", io.StringIO("w\nw\np\n"))   # 2 ticks, then quit
    cli.main(["teleop", "--seconds", "10", "--save", trace] + CPU64)
    out = capsys.readouterr().out
    assert "cmd=[+0.20" in out           # keys accumulated to 0.2 m/s
    assert "x realtime" in out
    assert np.load(trace)["com_pos"].shape[0] == 2 * 40


def test_plot_cli(standing_trace, tmp_path):
    png = str(tmp_path / "run.png")
    cli.main(["plot", standing_trace, "--out", png, "--skip", "0"])
    assert os.path.getsize(png) > 10000


def test_replay_cli(standing_trace, tmp_path):
    """Offline 3-D replay: the saved trace renders to an animated GIF with
    the port's forward kinematics a frame."""
    gif = str(tmp_path / "replay.gif")
    cli.main(["replay", standing_trace, "--out", gif, "--every", "10", "--max-frames", "4"])
    from PIL import Image

    assert Image.open(gif).n_frames == 4


def test_footprints_and_plot_from_the_cli(tmp_path):
    png, fp = str(tmp_path / "run.png"), str(tmp_path / "fp.png")
    cli.main(["standing", "--seconds", "0.02", "--plot", png, "--footprints", fp] + CPU64)
    assert os.path.getsize(png) > 10000 and os.path.getsize(fp) > 10000


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIGS, "*.yaml"))),
                         ids=os.path.basename)
def test_load_yaml_params_matches_jax(path):
    got, want = load_yaml_params(path), jax_load_yaml_params(path)
    assert sorted(got) == sorted(want) and got
    for key in got:
        g, w = got[key], want[key]
        for field in type(w).__dataclass_fields__:
            assert getattr(g, field) == getattr(w, field), (key, field)


def _trace_arrays(T=30, seed=0):
    rng = np.random.default_rng(seed)
    widths = dict(com_pos=3, com_pose=6, base_p=3, q=12, tau=12, grf=12, foot_pos=12,
                  ref_com_pose=6, ref_swing_pos=12, contacts=4)
    arrs = {k: rng.standard_normal((T, w)) for k, w in widths.items()}
    arrs["qp_kkt"] = rng.uniform(0, 1e-3, T)
    return arrs


def test_trace_arrays_and_files_match_jax(tmp_path):
    arrs = _trace_arrays()
    port = RolloutTrace(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    jax_trace = JaxRolloutTrace(**{k: jnp.asarray(v) for k, v in arrs.items()})
    got, want = plots.trace_to_arrays(port), jplots.trace_to_arrays(jax_trace)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    plots.save_trace(str(tmp_path / "p.npz"), port, 400.0)
    jplots.save_trace(str(tmp_path / "j.npz"), jax_trace, 400.0)
    back, jback = plots.load_trace(str(tmp_path / "p.npz")), jplots.load_trace(
        str(tmp_path / "j.npz"))
    assert list(back) == list(jback) and float(back["control_rate"]) == 400.0
    for k in jback:
        np.testing.assert_array_equal(back[k], jback[k])
        assert back[k].dtype == jback[k].dtype
