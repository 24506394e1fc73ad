"""Generic URDF -> lumped rigid-body model spec ("qrm-v1").

Python and numpy on the host, run once when a model is built
(`RobotModel.from_urdf`).  Fixed-joint subtrees are lumped exactly
(composite mass, CoM, rotated + parallel-axis inertia) into their nearest
movable ancestor, reducing e.g. the ANYmal-D URDF's 88 links / 87 joints to
13 rigid bodies + named end-effector frames: the same model reduction a
floating-base dynamics library performs implicitly for fixed joints (cf.
the reference controller's iDynTree model loading).

Masses and links inside XML comments are ignored: a regex over the
ANYmal-D URDF counts 65 mass entries / 57.124 kg, while the XML-visible
model is 62 inertial links / 51.636 kg, which is what iDynTree's
``getTotalMass`` (the reference's gravity wrench) returns.

The JAX package has the same parser; this package keeps its own copy so
that it imports nothing of that package.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def _rpy_to_matrix(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _parse_origin(el):
    if el is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
    return _rpy_to_matrix(*rpy), xyz


def _compose(T1, T2):
    R1, p1 = T1
    R2, p2 = T2
    return R1 @ R2, p1 + R1 @ p2


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


class _Link:
    def __init__(self, el):
        self.name = el.get("name")
        inertial = el.find("inertial")
        if inertial is None or inertial.find("mass") is None:
            self.mass = 0.0
            self.com = np.zeros(3)
            self.inertia = np.zeros((3, 3))
            self.R_inertial = np.eye(3)
        else:
            R, p = _parse_origin(inertial.find("origin"))
            self.R_inertial = R
            self.com = p  # URDF convention: inertial origin sits at the CoM
            self.mass = float(inertial.find("mass").get("value"))
            i = inertial.find("inertia")
            ixx = float(i.get("ixx")); ixy = float(i.get("ixy")); ixz = float(i.get("ixz"))
            iyy = float(i.get("iyy")); iyz = float(i.get("iyz")); izz = float(i.get("izz"))
            self.inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def parse_urdf(path: str, joint_order, frame_names, name: str = "robot") -> dict:
    """Parse a URDF file into a qrm-v1 spec dict.

    joint_order: the movable (revolute/continuous) joints, in the canonical
      model order (defines generalized-coordinate ordering).
    frame_names: link names exported as named frames (e.g. foot links).
    """
    root = ET.parse(path).getroot()
    links = {l.get("name"): _Link(l) for l in root.findall("link")}
    joints = {}
    child_to_joint = {}
    for j in root.findall("joint"):
        jname = j.get("name")
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        axis_el = j.find("axis")
        axis = (
            np.array([float(v) for v in axis_el.get("xyz").split()])
            if axis_el is not None
            else np.array([1.0, 0.0, 0.0])
        )
        limit_el = j.find("limit")
        limit = {}
        if limit_el is not None:
            for k in ("lower", "upper", "effort", "velocity"):
                if limit_el.get(k) is not None:
                    limit[k] = float(limit_el.get(k))
        joints[jname] = dict(
            name=jname, parent=parent, child=child, type=j.get("type"),
            T=_parse_origin(j.find("origin")), axis=axis, limit=limit,
        )
        child_to_joint[child] = jname

    root_candidates = [n for n in links if n not in child_to_joint]
    if len(root_candidates) != 1:
        raise ValueError(f"expected exactly one root link, got {root_candidates}")
    root_link = root_candidates[0]

    for n in joint_order:
        if n not in joints or joints[n]["type"] not in ("revolute", "continuous"):
            raise ValueError(f"joint {n!r} missing or not movable")

    def owner_and_transform(link_name):
        """Nearest movable ancestor body + fixed transform body->link."""
        T = (np.eye(3), np.zeros(3))
        cur = link_name
        while cur != root_link:
            j = joints[child_to_joint[cur]]
            if j["type"] != "fixed":
                return cur, T
            T = _compose(j["T"], T)
            cur = j["parent"]
        return root_link, T

    body_link_names = [root_link] + [joints[n]["child"] for n in joint_order]
    body_index = {n: i for i, n in enumerate(body_link_names)}

    lumped = [dict(mass=0.0, mcom=np.zeros(3), I_origin=np.zeros((3, 3))) for _ in body_link_names]
    for lname, link in links.items():
        if link.mass == 0.0 and not np.any(link.inertia):
            continue
        owner, (R_bl, p_bl) = owner_and_transform(lname)
        bi = body_index[owner]
        com_b = p_bl + R_bl @ link.com
        R_bi = R_bl @ link.R_inertial
        I_com_b = R_bi @ link.inertia @ R_bi.T
        S = _skew(com_b)
        lumped[bi]["mass"] += link.mass
        lumped[bi]["mcom"] += link.mass * com_b
        lumped[bi]["I_origin"] += I_com_b + link.mass * (S @ S.T)

    bodies = []
    for i, lname in enumerate(body_link_names):
        m = lumped[i]["mass"]
        com = lumped[i]["mcom"] / m if m > 0 else np.zeros(3)
        S = _skew(com)
        I_com = lumped[i]["I_origin"] - m * (S @ S.T)
        entry = dict(name=lname, mass=m, com=com.tolist(), inertia=I_com.tolist())
        if i == 0:
            entry["parent"] = -1
        else:
            j = joints[joint_order[i - 1]]
            powner, pT = owner_and_transform(j["parent"])
            R_pj, p_pj = _compose(pT, j["T"])
            entry["parent"] = body_index[powner]
            entry["joint"] = dict(
                name=j["name"], type=j["type"], R=R_pj.tolist(), p=p_pj.tolist(),
                axis=j["axis"].tolist(), limit=j["limit"],
            )
        bodies.append(entry)

    frames = []
    for fname in frame_names:
        owner, (R, p) = owner_and_transform(fname)
        frames.append(dict(name=fname, body=body_index[owner], R=R.tolist(), p=p.tolist()))

    return dict(
        name=name,
        source=path,
        format="qrm-v1",
        total_mass=float(sum(b["mass"] for b in bodies)),
        joint_names=list(joint_order),
        bodies=bodies,
        frames=frames,
    )
