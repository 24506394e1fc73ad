"""Command-line entry points of the port: the roslaunch / teleop layer.

Subcommands, flag for flag those of the JAX package's CLI, plus `--device`
(default `cuda`; `--device cpu` runs the kernels' plain versions):
  standing       quadruple-stance balance
  walk           static-walk gait (the reference's configuration)
  trot           trotting gait
  teleop-replay  closed loop driven by a recorded command stream (a CSV of
                 t, vx, vy, wz rows: the reference's teleop GUI was a
                 Twist source)
  teleop         live teleoperation from the keyboard or stdin
  sweep          batched robustness sweep over the ranks of a process group
  plot           the plot_bag.py panel set from a saved trace
  replay         offline 3-D replay of a saved trace to an animated GIF
  inspect        the model's forward kinematics at a joint configuration

Run:  python -m quadrupedwholebodycontroller_tpu_torch.cli.main <subcommand> [...]
      (or `qwbc-torch`); a sweep over N cards of one machine:
      torchrun --nproc_per_node=N -m quadrupedwholebodycontroller_tpu_torch.cli.main sweep
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
    load_yaml_params,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.parallel import (
    distributed_init,
    make_mesh,
    shard_batch,
    sharded_sweep_step,
)
from quadrupedwholebodycontroller_tpu_torch.planner import trot
from quadrupedwholebodycontroller_tpu_torch.runtime.native import TrajLog
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams
from quadrupedwholebodycontroller_tpu_torch.sim.rollout import (
    RolloutTrace,
    closed_loop_rollout,
    init_rollout_carry,
    trot_rollout,
)
from quadrupedwholebodycontroller_tpu_torch.sim.scenario import Scenario
from quadrupedwholebodycontroller_tpu_torch.viz import plots


def _common(ap):
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--qp-iters", type=int, default=100)
    ap.add_argument("--save", type=str, default=None, help="save trace .npz")
    ap.add_argument("--record", type=str, default=None,
                    help="save binary trajectory log (native TrajLog .qlog)")
    ap.add_argument("--plot", type=str, default=None, help="save plot .png")
    ap.add_argument("--footprints", type=str, default=None,
                    help="save top-down footprint plot .png")
    ap.add_argument("--params", type=str, default=None, help="reference-format yaml")


def _dtype(args):
    return torch.float32 if args.dtype == "float32" else torch.float64


def _setup(args, device=None):
    dtype = _dtype(args)
    device = torch.device(args.device if device is None else device)
    cp, pp = ControllerParams(), PlannerParams()
    if args.params:
        loaded = load_yaml_params(args.params)
        cp = loaded.get("controller", cp)
        pp = loaded.get("planner", pp)
    return dict(dtype=dtype, device=device, model=anymal_d_model(dtype, device), cp=cp,
                pp=pp, qp=QPSolverParams(iterations=args.qp_iters), sp=SimParams())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start(s, gait_name: str, batch: int = 1):
    """Every scenario at the reset pose, with the walk's or the trot's
    planner state."""
    planner_state = None
    if gait_name == "trot":
        planner_state = trot.init_trot_state(trot.TrotParams(), batch, s["dtype"], s["device"])
    return init_rollout_carry(s["model"], s["cp"], batch, s["pp"], s["dtype"], s["device"],
                              planner_state=planner_state)


def _loop(s, gait_name: str):
    """(carry, commands (1, T, 3)) -> (carry, trace): the single robot's
    closed loop with the walk or the trot."""
    if gait_name == "trot":
        tp = trot.TrotParams()
        return lambda c, x: trot_rollout(s["model"], s["cp"], tp, s["qp"], s["sp"], c, x)
    return lambda c, x: closed_loop_rollout(s["model"], s["cp"], s["pp"], s["qp"], s["sp"],
                                            c, x)


def _row(trace) -> RolloutTrace:
    """Scenario 0 of a trace (B, T, ...) as numpy (T, ...)."""
    return RolloutTrace(*(x[0].detach().cpu().numpy() for x in trace))


def _finish(args, trace, cp):
    arrs = plots.trace_to_arrays(trace)
    kkt = arrs["qp_kkt"]
    print(
        f"T={len(kkt)} steps | qp kkt med={np.median(kkt):.2e} max={kkt.max():.2e} | "
        f"com z=[{arrs['com_pos'][:, 2].min():.3f},{arrs['com_pos'][:, 2].max():.3f}] | "
        f"x travel={arrs['com_pos'][-1, 0] - arrs['com_pos'][0, 0]:.3f} m | "
        f"tau max={np.abs(arrs['tau']).max():.1f} N m"
    )
    if args.save:
        plots.save_trace(args.save, trace, cp.loop_rate)
        print("trace ->", args.save)
    if getattr(args, "record", None):
        # frame: [q(12), com_pose(6), tau(12), grf(12)], the four topics the
        # reference records (launch/whole_body_controller.launch:27-35)
        frames = np.concatenate([arrs["q"], arrs["com_pose"], arrs["tau"], arrs["grf"]],
                                axis=1)
        log = TrajLog(frame_doubles=frames.shape[1])
        try:
            log.append(frames)
            log.flush(args.record)
        finally:
            log.close()
        print("binary log ->", args.record)
    if args.plot:
        plots.plot_run(arrs, skip_seconds=0.5, control_rate=cp.loop_rate, out_path=args.plot)
        print("plot ->", args.plot)
    if getattr(args, "footprints", None):
        plots.plot_footprints(arrs, out_path=args.footprints)
        print("footprints ->", args.footprints)


def _drive(args, name: str, gait_name: str, make_cmds):
    """The single robot's closed loop over the commands `make_cmds(loop_rate)`
    gives ((T, 3) [vx, vy, wz] per control step), timed, then the summary
    line and the outputs asked for."""
    s = _setup(args)
    carry = _start(s, gait_name)
    cmds = torch.as_tensor(make_cmds(s["cp"].loop_rate), dtype=s["dtype"]).to(s["device"])
    t0 = time.time()
    _, trace = _loop(s, gait_name)(carry, cmds[None])
    _sync(s["device"])
    if name:
        print(f"{name} {args.seconds}s sim in {time.time() - t0:.1f}s wall")
    _finish(args, _row(trace), s["cp"])


def _gait_commands(args):
    """0.25 s standing, then (vx, vy, wz)."""
    def make(loop_rate):
        cmds = np.zeros((int(args.seconds * loop_rate), 3))
        cmds[int(0.25 * loop_rate):] = (args.vx, args.vy, args.wz)
        return cmds

    return make


def cmd_standing(args):
    _drive(args, "standing", "walk", lambda rate: np.zeros((int(args.seconds * rate), 3)))


def cmd_walk(args):
    _drive(args, "walk", "walk", _gait_commands(args))


def cmd_trot(args):
    _drive(args, "trot", "trot", _gait_commands(args))


def cmd_teleop_replay(args):
    # command stream: CSV rows "t,vx,vy,wz", zero-order held (Twist semantics)
    stream = np.loadtxt(args.stream, delimiter=",", ndmin=2)

    def make(rate):
        T = int(stream[-1, 0] * rate) + 1
        idx = np.searchsorted(stream[:, 0], np.arange(T) / rate, side="right") - 1
        return stream[np.clip(idx, 0, len(stream) - 1), 1:4]

    _drive(args, "", "walk", make)


def cmd_teleop(args):
    """Live teleoperation: a keyboard / stdin command source driving a
    running closed loop (the reference's Qt slider GUI publishing Twists at
    10 Hz, src/teleop_gui_node.cpp:10-82, for a terminal): the simulation
    advances in 100 ms segments (one 10 Hz teleop tick = loop_rate / 10
    control steps, the command held across the segment), and between
    segments the command is updated from whatever arrived on stdin.

    Keys (single keystroke on a TTY; one per line when piped):
      w/s  vx +/- 0.1 m/s      a/d  vy +/- 0.05 m/s
      q/e  wz +/- 0.1 rad/s    x/space  full stop
      p    quit (also EOF or --seconds elapsed)
    """
    import select

    s = _setup(args)
    rate = 10.0  # teleop tick rate (the reference's publishVel timer: 100 ms)
    seg = max(1, int(round(s["cp"].loop_rate / rate)))
    carry = _start(s, "walk")
    fn = _loop(s, "walk")

    is_tty = sys.stdin.isatty()
    if is_tty:
        import termios
        import tty

        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    def poll_keys():
        """TTY: drain every waiting keystroke.  Piped: consume exactly one
        line per tick (a scripted session advances one command per tick; an
        empty line holds the command), EOF = quit."""
        if not is_tty:
            line = sys.stdin.readline()
            if line == "":
                return ["p"]
            return list(line.strip())
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "":
                keys.append("p")  # EOF = quit
                break
            ch = ch.strip("\n\r")
            if ch:
                keys.append(ch)
        return keys

    vmax = np.array([0.8, 0.4, 0.6])  # slider ranges of vx, vy, wz (teleop_gui_node.cpp)
    steps = {"w": (0, 0.1), "s": (0, -0.1), "a": (1, 0.05), "d": (1, -0.05),
             "q": (2, 0.1), "e": (2, -0.1)}
    cmd = np.zeros(3)
    traces = []
    n_ticks = int(args.seconds * rate) if args.seconds > 0 else 10**9
    t0 = time.time()
    try:
        print(f"teleop: w/s=vx a/d=vy q/e=wz x=stop p=quit "
              f"(tick {1000 / rate:.0f} ms = {seg} control steps)")
        for tick in range(n_ticks):
            keys = poll_keys()
            for k in keys:
                if k in steps:
                    cmd[steps[k][0]] += steps[k][1]
                elif k in ("x", " "):
                    cmd[:] = 0.0
            if "p" in keys:
                break
            cmd = np.clip(cmd, -vmax, vmax)
            cmds = torch.as_tensor(cmd, dtype=s["dtype"]).to(s["device"]).expand(1, seg, 3)
            carry, trace = fn(carry, cmds.contiguous())
            traces.append(_row(trace))
            com = traces[-1].com_pos[-1]
            print(
                f"\r t={(tick + 1) / rate:6.1f}s cmd=[{cmd[0]:+.2f} {cmd[1]:+.2f} "
                f"{cmd[2]:+.2f}] com=[{com[0]:+.3f} {com[1]:+.3f} {com[2]:.3f}] ",
                end="", flush=True,
            )
    finally:
        if is_tty:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
    wall = time.time() - t0
    print()
    if not traces:
        print("no ticks ran")
        return
    trace = RolloutTrace(*(np.concatenate(xs) for xs in zip(*traces)))
    sim_s = trace.com_pos.shape[0] / s["cp"].loop_rate
    print(f"teleop {sim_s:.1f}s sim in {wall:.1f}s wall ({sim_s / wall:.2f}x realtime)")
    _finish(args, trace, s["cp"])


def cmd_sweep(args):
    """The robustness sweep: B scenarios (forward speeds uniform in 0-0.8
    m/s from control step 40, friction x payload x one push, drawn from a
    generator seeded by --seed) over the ranks of the process group (one
    process without one; torchrun's variables make one), each rank on its
    shard."""
    made = distributed_init(device=args.device)
    try:
        mesh = make_mesh(device=None if dist.is_initialized() else args.device)
        s = _setup(args, mesh.device)
        B, T = args.batch, int(args.seconds * s["cp"].loop_rate)
        g = torch.Generator().manual_seed(args.seed)
        vx = 0.8 * torch.rand(B, generator=g, dtype=torch.float64)
        cmds = torch.zeros((B, T, 3), dtype=torch.float64)
        cmds[:, 40:, 0] = vx[:, None]
        scen = Scenario.random_batch(g, B, T, s["dtype"], mesh.device)
        carry = _start(s, args.gait, B)
        step = sharded_sweep_step(s["model"], s["cp"], s["pp"], s["qp"], s["sp"], mesh,
                                  args.gait)
        carry, cmds, scen = shard_batch((carry, cmds.to(mesh.device, s["dtype"]), scen), mesh)
        t0 = time.time()
        _, metrics = step(carry, cmds, scen)
        _sync(mesh.device)
        dt = time.time() - t0
        if mesh.rank == 0:
            print(
                f"sweep B={B} T={T} on {mesh.size} devices in {dt:.1f}s | "
                f"{B * T / dt:,.0f} control-steps/s | mean_kkt={float(metrics.mean_kkt):.2e} "
                f"max_kkt={float(metrics.max_kkt):.2e} "
                f"fallen={float(metrics.fallen_fraction):.3f}"
            )
    finally:
        if made:
            dist.destroy_process_group()


def cmd_inspect(args):
    """Model inspector, the headless counterpart of the reference's
    standalone.launch (joint sliders, robot_state_publisher, RViz;
    launch/standalone.launch:19-39): the forward-kinematics view of the
    model at a joint configuration (frame poses, CoM, masses), optionally
    as a rendered skeleton."""
    dtype, device = _dtype(args), torch.device(args.device)
    model = anymal_d_model(dtype, device)
    kw = dict(dtype=dtype, device=device)
    q = [float(v) for v in args.q.split(",")] if args.q else INITIAL_JOINT_POS
    if len(q) != model.num_joints:
        raise SystemExit(f"expected {model.num_joints} joint angles, got {len(q)}")
    q = torch.tensor(q, **kw)
    kin = K.forward_kinematics(model, torch.eye(3, **kw), torch.tensor([0.0, 0.0, args.z], **kw),
                               q)
    com = K.robot_com(model, kin).cpu().numpy()
    joint_origin, frame_p = kin.joint_origin_w.cpu().numpy(), kin.frame_p.cpu().numpy()

    print(f"model: {model.name}  bodies={model.num_bodies} joints={model.num_joints} "
          f"total_mass={float(model.total_mass):.4f} kg")
    print(f"com: [{com[0]:+.4f} {com[1]:+.4f} {com[2]:+.4f}]")
    for j, name in enumerate(model.joint_names):
        print(f"  joint {name:10s} q={float(q[j]):+.4f} rad  "
              f"origin={np.round(joint_origin[j], 4)}")
    for f, name in enumerate(model.frame_names):
        print(f"  frame {name:10s} p={np.round(frame_p[f], 4)}")
    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        bp = kin.body_p.cpu().numpy()
        for b in range(1, model.num_bodies):
            ax.plot(*zip(bp[model.parent[b]], bp[b]), "o-", color="tab:blue", ms=3)
        ax.scatter(frame_p[:, 0], frame_p[:, 1], frame_p[:, 2], c="tab:red", s=30,
                   label="feet")
        ax.scatter([com[0]], [com[1]], [com[2]], c="k", marker="x", s=60, label="CoM")
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
        ax.legend(); ax.set_title(f"{model.name} @ z={args.z}")
        fig.savefig(args.out, dpi=110)
        plt.close(fig)
        print("skeleton ->", args.out)


def cmd_plot(args):
    arrs = plots.load_trace(args.trace)
    plots.plot_run(arrs, skip_seconds=args.skip, out_path=args.out)
    print("plot ->", args.out)


def cmd_replay(args):
    """Offline 3-D replay of a saved trace to an animated GIF (the RViz live
    view, for a headless machine)."""
    arrs = plots.load_trace(args.trace)
    plots.render_replay(arrs, anymal_d_model(torch.float64, "cpu"), args.out,
                        every=args.every, max_frames=args.max_frames)
    print("replay ->", args.out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qwbc-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("standing"); _common(p); p.set_defaults(fn=cmd_standing)
    for name, fn in [("walk", cmd_walk), ("trot", cmd_trot)]:
        p = sub.add_parser(name); _common(p)
        p.add_argument("--vx", type=float, default=0.5)
        p.add_argument("--vy", type=float, default=0.0)
        p.add_argument("--wz", type=float, default=0.0)
        p.set_defaults(fn=fn)
    p = sub.add_parser("teleop-replay"); _common(p)
    p.add_argument("stream", help="CSV of t,vx,vy,wz")
    p.set_defaults(fn=cmd_teleop_replay)
    p = sub.add_parser("teleop"); _common(p)
    p.set_defaults(fn=cmd_teleop)
    p = sub.add_parser("sweep"); _common(p)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gait", choices=["walk", "trot"], default="walk")
    p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("plot")
    p.add_argument("trace"); p.add_argument("--out", default="run.png")
    p.add_argument("--skip", type=float, default=3.0)
    p.set_defaults(fn=cmd_plot)
    p = sub.add_parser("replay")
    p.add_argument("trace"); p.add_argument("--out", default="replay.gif")
    p.add_argument("--every", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=120)
    p.set_defaults(fn=cmd_replay)
    p = sub.add_parser("inspect")
    p.add_argument("--q", default="", help="12 comma-separated joint angles (rad)")
    p.add_argument("--z", type=float, default=0.6, help="base height")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--out", default="", help="save a 3D skeleton png")
    p.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
