"""Offline trajectory analysis: the reference's scripts/plot_bag.py.

Renders the reference bag plotter's panel set (per-leg joint positions,
base / CoM pose (xyz and rpy), commanded torques, desired vertical ground
forces) from a rollout's trace (its tensors, or a saved .npz) instead of a
rosbag, skipping an initial transient as the reference does (3 s by
default); a top-down footprint view; and an offline 3-D replay.  matplotlib
is imported only inside the functions that draw.
"""
from __future__ import annotations

import numpy as np
import torch

from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import spatial

LEG_NAMES = ("LH", "LF", "RF", "RH")
JOINT_SUFFIX = ("HAA", "HFE", "KFE")


def trace_to_arrays(trace) -> dict:
    """One robot's RolloutTrace (leaves (T, ...): tensors or numpy arrays;
    a rollout's trace is (B, T, ...), take one scenario's row) -> dict of
    numpy arrays."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in trace._asdict().items()}


def save_trace(path: str, trace, control_rate: float = 400.0):
    arrs = trace_to_arrays(trace)
    arrs["control_rate"] = np.asarray(control_rate)
    np.savez_compressed(path, **arrs)


def load_trace(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def plot_run(arrs: dict, skip_seconds: float = 3.0, control_rate: float = 400.0,
             out_path: str | None = None, show: bool = False):
    """The four reference panels.  arrs: dict from trace_to_arrays/load_trace."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rate = float(arrs.get("control_rate", control_rate))
    skip = int(skip_seconds * rate)
    T = arrs["q"].shape[0]
    skip = min(skip, max(0, T - 2))
    t = np.arange(T)[skip:] / rate

    fig, axes = plt.subplots(2, 2, figsize=(14, 9))

    # 1) joint positions per leg (plot_bag.py joint panel)
    ax = axes[0, 0]
    q = arrs["q"][skip:]
    for leg in range(4):
        for j in range(3):
            ax.plot(t, q[:, 3 * leg + j],
                    label=f"{LEG_NAMES[leg]}_{JOINT_SUFFIX[j]}", lw=0.8)
    ax.set_title("joint positions [rad]")
    ax.legend(ncol=4, fontsize=6)

    # 2) CoM/base pose xyz + rpy (plot_bag.py base pose panel)
    ax = axes[0, 1]
    pose = arrs["com_pose"][skip:]
    ref = arrs.get("ref_com_pose")
    for i, lbl in enumerate(["x", "y", "z", "roll", "pitch", "yaw"]):
        ax.plot(t, pose[:, i], label=lbl, lw=0.9)
        if ref is not None:
            ax.plot(t, ref[skip:, i], ls="--", lw=0.6, color=ax.lines[-1].get_color())
    ax.set_title("CoM pose (solid) vs reference (dashed)")
    ax.legend(ncol=3, fontsize=7)

    # 3) commanded torques (plot_bag.py torque panel)
    ax = axes[1, 0]
    tau = arrs["tau"][skip:]
    for i in range(12):
        ax.plot(t, tau[:, i], lw=0.6)
    ax.axhline(80, color="r", ls=":", lw=0.8)
    ax.axhline(-80, color="r", ls=":", lw=0.8)
    ax.set_title("commanded torques [N m]")

    # 4) desired vertical GRFs per leg (plot_bag.py GRF panel)
    ax = axes[1, 1]
    grf = arrs["grf"][skip:].reshape(len(t), 4, 3)
    for leg in range(4):
        ax.plot(t, grf[:, leg, 2], label=LEG_NAMES[leg], lw=0.9)
    ax.set_title("desired vertical GRFs [N]")
    ax.legend(fontsize=7)

    for ax in axes.flat:
        ax.set_xlabel("t [s]")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    if show:
        plt.show()
    return fig


def render_replay(arrs: dict, model, out_path: str, every: int = 8,
                  control_rate: float = 400.0, max_frames: int = 120,
                  elev: float = 18.0, azim: float = -60.0):
    """Offline 3-D replay of a saved trace — the RViz live-view analogue
    (reference launch/standalone.launch RViz + robot_state_publisher; this
    environment is headless, so the replay renders to an animated GIF).

    Reconstructs full kinematics per frame from the trace (q + base pose;
    base orientation from the logged rpy) with the port's kinematics in
    float64 on the CPU, and draws the skeleton, feet and the
    desired-vs-realized CoM.  `every` subsamples control steps
    (default 8 → 50 fps of sim time at 400 Hz)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    rate = float(arrs.get("control_rate", control_rate))
    T = arrs["q"].shape[0]
    idx = np.arange(0, T, every)[:max_frames]
    model64 = model.to(torch.float64, "cpu")
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)

    def fk(k):
        R = spatial.rpy_to_matrix(f64(arrs["com_pose"][k, 3:6]))
        kin = K.forward_kinematics(model64, R, f64(arrs["base_p"][k]), f64(arrs["q"][k]))
        return kin.body_p.numpy(), kin.frame_p.numpy()

    frames = [fk(k) for k in idx]
    com = arrs["com_pose"]
    ref = arrs.get("ref_com_pose")

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    all_bp = np.concatenate([f[0] for f in frames])
    ax.set_xlim(all_bp[:, 0].min() - 0.4, all_bp[:, 0].max() + 0.4)
    ax.set_ylim(all_bp[:, 1].min() - 0.4, all_bp[:, 1].max() + 0.4)
    ax.set_zlim(0.0, 0.9)
    ax.view_init(elev=elev, azim=azim)
    n_feet = len(model.frame_body)
    bones = [
        ax.plot([], [], [], "o-", color="tab:blue", ms=3, lw=1.5)[0]
        for _ in range(1, model.num_bodies)
    ] + [
        ax.plot([], [], [], "-", color="tab:blue", lw=1.5)[0]
        for _ in range(n_feet)  # shank -> foot frame segments
    ]
    feet_pts = ax.plot([], [], [], "o", color="tab:red", ms=5)[0]
    com_line = ax.plot([], [], [], "k-", lw=1.0, label="CoM")[0]
    if ref is not None:
        ax.plot(ref[:, 0], ref[:, 1], ref[:, 2], "k--", lw=0.7, label="reference")
    title = ax.set_title("")
    ax.legend(fontsize=7)

    def update(i):
        bp, fp = frames[i]
        k = idx[i]
        for b in range(1, model.num_bodies):
            pa, pb = bp[model.parent[b]], bp[b]
            bones[b - 1].set_data([pa[0], pb[0]], [pa[1], pb[1]])
            bones[b - 1].set_3d_properties([pa[2], pb[2]])
        for f in range(n_feet):
            pa, pb = bp[model.frame_body[f]], fp[f]
            line = bones[model.num_bodies - 1 + f]
            line.set_data([pa[0], pb[0]], [pa[1], pb[1]])
            line.set_3d_properties([pa[2], pb[2]])
        feet_pts.set_data(fp[:, 0], fp[:, 1])
        feet_pts.set_3d_properties(fp[:, 2])
        com_line.set_data(com[:k + 1, 0], com[:k + 1, 1])
        com_line.set_3d_properties(com[:k + 1, 2])
        title.set_text(f"t = {k / rate:.2f} s")
        return bones + [feet_pts, com_line, title]

    anim = FuncAnimation(fig, update, frames=len(frames), blit=False)
    anim.save(out_path, writer=PillowWriter(fps=max(1, int(rate / every / 2))))
    plt.close(fig)
    return out_path


def plot_footprints(arrs: dict, out_path: str | None = None, show: bool = False,
                    body_every_s: float = 0.5, control_rate: float = 400.0):
    """Top-down reference-vs-realized view — the RViz marker-publisher
    analogue (reference src/marker_publisher.cpp): the planner's DESIRED
    body rectangle (0.55 x 0.35, yaw-oriented, cpp:47-75) and swing-foot
    targets (red spheres, cpp:12-39) drawn over the realized CoM path and
    stance footprints, so commanded and achieved motion are visible in one
    figure."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle
    from matplotlib.transforms import Affine2D

    fig, ax = plt.subplots(figsize=(8, 6))
    com = arrs["com_pose"]
    ax.plot(com[:, 0], com[:, 1], "k-", lw=1.2, label="CoM path")
    ref = arrs.get("ref_com_pose")
    contacts = arrs.get("contacts")
    if ref is not None:
        ax.plot(ref[:, 0], ref[:, 1], "k--", lw=0.8, label="reference")
        # desired body rectangles (marker_publisher.cpp draw_rectangle:
        # 0.55 x 0.35 cube at the desired CoM pose, rotated by desired yaw)
        rate = float(arrs.get("control_rate", control_rate))
        stride = max(1, int(body_every_s * rate))
        for k in range(0, len(ref), stride):
            x, y, yaw = ref[k, 0], ref[k, 1], ref[k, 5]
            r = Rectangle(
                (x - 0.275, y - 0.175), 0.55, 0.35,
                fill=False, ec="tab:blue", lw=0.7, alpha=0.6,
                transform=Affine2D().rotate_around(x, y, yaw) + ax.transData,
            )
            ax.add_patch(r)
        ax.plot([], [], color="tab:blue", lw=0.7, label="desired body")
    feet = arrs["foot_pos"].reshape(len(com), 4, 3)
    colors = ["tab:red", "tab:blue", "tab:green", "tab:orange"]
    for leg, (name, c) in enumerate(zip(LEG_NAMES, colors)):
        if contacts is not None:
            stance = contacts[:, leg] > 0.5
        else:
            stance = np.ones(len(com), bool)
        ax.plot(
            feet[stance, leg, 0], feet[stance, leg, 1], ".", ms=2,
            color=c, label=f"{name} stance",
        )
    # desired swing-foot targets (the red-sphere channel)
    swing_ref = arrs.get("ref_swing_pos")
    if swing_ref is not None and contacts is not None:
        sw = swing_ref.reshape(len(com), 4, 3)
        pts = sw[contacts < 0.5]  # (num_swing_samples, 3)
        if len(pts):
            ax.plot(pts[:, 0], pts[:, 1], "o", ms=3, mfc="none",
                    color="red", alpha=0.5, label="swing target")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    if show:
        plt.show()
    return fig
