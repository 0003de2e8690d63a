"""Raycast simulator: the C++ BVH renderer over a scene mesh (counterpart
of naruto_tpu/sim/raycast.py).

Loads a scene mesh (a ``.ply`` with vertex colours, a ``.glb``/``.gltf``,
a scene directory holding ``mesh.ply``, or a habitat ``stage_config``
json), builds a BVH in the C++ core (native/raycaster.cpp, the JAX
package's renderer, built by native/build.py) and serves pinhole RGB-D and
ERP RGB-distance frames at the engine's poses. Sensor conventions match the
reference: pinhole z-depth (invalid = 0), ERP radial distance (miss ->
sim.invalid_depth_value), RDF camera-to-world poses.

The renderer runs on the host, with OpenMP. ``simulate`` returns what the
analytic simulator returns, tensors on the run's device with colour in
[0, 1]; ``host_frame`` is the frame on the host, its colour quantized to
uint8 (a quarter of the bytes) by the expression the JAX package's mapper
applies to the same host frame, and ``frame`` copies it to the device.
``probe_erp_dist`` returns host numpy: its consumer, the planner's
collision rule, runs on the host.

Dynamic rigid objects (``sim.objects``) and their physics are as in the
JAX package: constant velocities in the start camera's frame, one initial
1.0 s settle, one ``sim.physics_dt`` tick per step index, gravity settling
and wall contact by one-pixel casts.
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.sim.base import Simulator, quantize_color
from naruto_tpu_torch.utils.printer import InfoPrinter


def _load_lib():
    from naruto_tpu_torch.native.build import ensure_built

    lib = ctypes.CDLL(ensure_built("raycaster"))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rc_create.restype = ctypes.c_void_p
    lib.rc_create.argtypes = [fp, ctypes.c_int, fp, ip, ctypes.c_int]
    lib.rc_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_render_pinhole.argtypes = [
        ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, fp, fp]
    lib.rc_render_erp.argtypes = [
        ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        fp, fp]
    lib.rc_probe_erp.argtypes = [
        ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, ctypes.c_float, fp]
    lib.rc_set_force_scalar.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rc_add_object.restype = ctypes.c_int
    lib.rc_add_object.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, fp, ip,
                                  ctypes.c_int]
    lib.rc_set_object_pose.argtypes = [ctypes.c_void_p, ctypes.c_int, fp]
    return lib


def _primitive_mesh(template: str):
    """Procedural object meshes: "sphere:R" (uv-sphere) or "box:sx,sy,sz"
    (stand-ins for the reference's object template assets); mesh-file
    templates load through ply/gltf."""
    kind, _, arg = template.partition(":")
    if kind == "sphere":
        r = float(arg or 0.2)
        n_lat, n_lon = 12, 18
        lat = np.linspace(0, np.pi, n_lat)
        lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
        verts = np.asarray([[r * np.sin(th) * np.cos(ph), r * np.cos(th),
                             r * np.sin(th) * np.sin(ph)]
                            for th in lat for ph in lon], np.float32)
        faces = []
        for i in range(n_lat - 1):
            for j in range(n_lon):
                a = i * n_lon + j
                b = i * n_lon + (j + 1) % n_lon
                c = (i + 1) * n_lon + j
                d = (i + 1) * n_lon + (j + 1) % n_lon
                faces += [[a, b, c], [b, d, c]]
        colors = np.full((len(verts), 3), (0.9, 0.3, 0.2), np.float32)
        return verts, np.asarray(faces, np.int32), colors
    if kind == "box":
        s = np.asarray([float(v) for v in (arg or "0.3,0.3,0.3").split(",")],
                       np.float32) / 2.0
        v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float32) * s
        quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4),
                 (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
        faces = []
        for a, b, c, d in quads:
            faces += [[a, b, c], [a, c, d]]
        colors = np.full((8, 3), (0.2, 0.5, 0.9), np.float32)
        return v, np.asarray(faces, np.int32), colors
    raise ValueError(f"unknown object template {template!r}")


def _read_ply_mesh(path: str):
    from naruto_tpu_torch.mesh.ply import read_ply

    v, f, c = read_ply(path)
    return (v.astype(np.float32), f.astype(np.int32),
            c.astype(np.float32) / 255.0 if c is not None else None)


def _load_object_mesh(template: str):
    if template.lower().endswith(".ply"):
        return _read_ply_mesh(template)
    if template.lower().endswith((".glb", ".gltf")):
        from naruto_tpu_torch.mesh.gltf import load_gltf

        return load_gltf(template)
    return _primitive_mesh(template)


def load_scene_mesh(cfg: MainConfig):
    """(verts, faces, colours in [0, 1] or None) of sim.scene_path, or of
    the render asset of sim.stage_config; stage_up / stage_front orient a
    glTF asset (the stage config's unless the config overrides them)."""
    path = cfg.sim.scene_path
    up, front = cfg.sim.stage_up, cfg.sim.stage_front
    if cfg.sim.stage_config:
        with open(cfg.sim.stage_config) as f:
            stage = json.load(f)
        path = os.path.normpath(os.path.join(
            os.path.dirname(os.path.abspath(cfg.sim.stage_config)),
            stage["render_asset"]))
        up = up if up is not None else stage.get("up")
        front = front if front is not None else stage.get("front")
    if os.path.isdir(path):
        # a scene directory: mesh.ply (+ traj.txt for passive replays)
        path = os.path.join(path, "mesh.ply")
    if path.lower().endswith((".glb", ".gltf")):
        from naruto_tpu_torch.mesh.gltf import load_gltf

        return load_gltf(path, up=up, front=front)
    return _read_ply_mesh(path)


def _rotvec_matrix(rotvec: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _pose16(c2w) -> np.ndarray:
    if isinstance(c2w, torch.Tensor):
        c2w = c2w.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(c2w, dtype=np.float32)).reshape(16)


class RaycastSimulator(Simulator):
    def __init__(self, cfg: MainConfig, device="cuda",
                 printer: Optional[InfoPrinter] = None,
                 verts: Optional[np.ndarray] = None,
                 faces: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None):
        super().__init__(cfg, printer)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RaycastSimulator(device='cuda') needs a CUDA "
                               "device and none is available")
        self._lib = _load_lib()
        if verts is None:
            verts, faces, colors = load_scene_mesh(cfg)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        faces = np.ascontiguousarray(faces, dtype=np.int32)
        if colors is not None:
            colors = np.ascontiguousarray(colors, dtype=np.float32)
        self._handle = self._lib.rc_create(
            _fp(verts), len(verts),
            _fp(colors) if colors is not None else None,
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces))
        self._keepalive = (verts, faces, colors)
        self.n_verts, self.n_faces = len(verts), len(faces)
        self.invalid = cfg.sim.invalid_depth_value

        # dynamic rigid objects: location/velocity/angular velocity in the
        # start camera's frame, one initial 1.0 s physics step, then one
        # sim.physics_dt tick per step index when physics_dt > 0
        self._obj_states: list = []
        self._physics_step = 0
        self._phys_lock = threading.Lock()
        if cfg.sim.objects:
            self._spawn_objects(cfg.sim.objects)
            self.step_physics(1.0)

    # ---------------------------------------------------- dynamic objects
    def _spawn_objects(self, specs) -> None:
        start = (np.asarray(self.cfg.start_c2w, dtype=np.float32)
                 if self.cfg.start_c2w is not None
                 else np.eye(4, dtype=np.float32))
        R_cam, t_cam = start[:3, :3], start[:3, 3]
        for spec in specs:
            v, f, c = _load_object_mesh(spec["template"])
            loc = np.asarray(spec.get("location", (0, 0, 1)), np.float32)
            vel = np.asarray(spec.get("velocity", (0, 0, 0)), np.float32)
            ang = np.asarray(spec.get("angular_velocity", (0, 0, 0)),
                             np.float32)
            rot = spec.get("rotation")  # [deg, x, y, z] like rotate_local
            R0 = np.eye(3, dtype=np.float32)
            if rot is not None:
                axis = np.asarray(rot[1:4], np.float32)
                axis = axis / max(np.linalg.norm(axis), 1e-9)
                R0 = _rotvec_matrix(axis * np.deg2rad(rot[0]))
            obj_id = self.add_object(v, f, c)
            self._obj_states.append({
                "id": obj_id,
                "pos": R_cam @ loc + t_cam,           # camera -> world
                "vel": R_cam @ vel,
                "angvel": R_cam @ ang,                # rad/s, world frame
                "rot": R0,
                "obj_verts": v,                       # for support casts
            })
            self._set_pose_from_state(self._obj_states[-1])

    def add_object(self, verts: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> int:
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        faces = np.ascontiguousarray(faces, dtype=np.int32)
        if colors is not None:
            colors = np.ascontiguousarray(colors, dtype=np.float32)
        return int(self._lib.rc_add_object(
            self._handle, _fp(verts), len(verts),
            _fp(colors) if colors is not None else None,
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces)))

    def set_object_pose(self, obj_id: int, o2w: np.ndarray) -> None:
        self._lib.rc_set_object_pose(self._handle, obj_id, _fp(_pose16(o2w)))

    def _set_pose_from_state(self, st) -> None:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = st["rot"]
        T[:3, 3] = st["pos"]
        self.set_object_pose(st["id"], T)

    def _cast_distance(self, origin: np.ndarray, fwd: np.ndarray) -> float:
        """Distance to the first surface from `origin` along unit `fwd`,
        by one 1x1-pixel depth render; np.inf on a miss."""
        up = (np.array([0.0, 0.0, 1.0], np.float32)
              if abs(fwd[2]) < 0.9 else np.array([1.0, 0.0, 0.0], np.float32))
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), 1e-9)
        down = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0] = right
        c2w[:3, 1] = down
        c2w[:3, 2] = fwd
        c2w[:3, 3] = origin
        color = np.empty((1, 1, 3), dtype=np.float32)
        depth = np.empty((1, 1), dtype=np.float32)
        self._lib.rc_render_pinhole(
            self._handle, _fp(_pose16(c2w)), 1, 1,
            ctypes.c_float(1.0), ctypes.c_float(1.0),
            ctypes.c_float(0.5), ctypes.c_float(0.5),
            _fp(color), _fp(depth))
        d = float(depth[0, 0])
        return d if d > 0.0 else np.inf

    def _support_distance(self, st) -> float:
        """Distance from the object's lowest point to the first surface
        straight below it (world -z), cast from just under the object so
        its own triangles cannot self-hit; np.inf on a miss."""
        zmin = float((st["obj_verts"] @ st["rot"].T)[:, 2].min())
        origin = st["pos"] + np.array([0.0, 0.0, zmin - 1e-3], np.float32)
        return self._cast_distance(
            origin, np.array([0.0, 0.0, -1.0], np.float32))

    def _clamped_translate(self, st, disp: np.ndarray) -> bool:
        """Move the object by `disp`, stopping just short of the first
        surface along it (one ray from the object's leading extent).
        Returns True on contact (the caller zeroes the velocity)."""
        n = float(np.linalg.norm(disp))
        if n <= 0.0:
            return False
        d = disp / n
        ext = float(((st["obj_verts"] @ st["rot"].T) @ d).max())
        origin = st["pos"] + d * (ext + 1e-3)
        free = self._cast_distance(origin, d.astype(np.float32))
        if n >= free - 1e-3:
            st["pos"] = st["pos"] + d * max(free - 1e-3, 0.0)
            return True
        st["pos"] = st["pos"] + disp
        return False

    def step_physics(self, dt: float) -> None:
        """Advance the objects: constant linear/angular velocity, plus
        (sim.gravity > 0) a vertical free fall clamped at the first support
        below, the fall velocity's displacement included."""
        g = float(self.cfg.sim.gravity)
        for st in self._obj_states:
            if g > 0.0:
                h_disp = np.array(
                    [st["vel"][0] * dt, st["vel"][1] * dt, 0.0], np.float32)
                if self._clamped_translate(st, h_disp):
                    st["vel"][0] = st["vel"][1] = 0.0
                drop = -(st["vel"][2] * dt) + 0.5 * g * dt * dt
                support = self._support_distance(st)
                if drop >= support - 1e-3:        # contact: come to rest
                    st["pos"][2] -= max(support - 1e-3, 0.0)
                    st["vel"][2] = 0.0
                else:
                    st["pos"][2] -= drop          # signed: <0 moves up
                    st["vel"][2] -= g * dt
            else:
                if self._clamped_translate(st, st["vel"] * dt):
                    st["vel"] = np.zeros(3, np.float32)
            w = st["angvel"] * dt
            if np.linalg.norm(w) > 0:
                st["rot"] = _rotvec_matrix(w) @ st["rot"]
            self._set_pose_from_state(st)

    def update_step(self, step: int) -> None:
        """Advance to `step`: exactly one physics_dt tick per step index
        (repeated or earlier indices are no-ops)."""
        super().update_step(step)
        if self._obj_states and self.cfg.sim.physics_dt > 0:
            with self._phys_lock:
                while self._physics_step < step:
                    self.step_physics(self.cfg.sim.physics_dt)
                    self._physics_step += 1

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rc_destroy(self._handle)
            self._handle = None

    # ----------------------------------------------------------- rendering
    def render_host(self, c2w, return_erp: bool = False):
        """The renderer's host numpy output: (colour [H, W, 3] f32 in
        [0, 1], depth [H, W]) and, with return_erp, (erp_color, erp_dist)."""
        cfg = self.cfg
        H, W = cfg.sim.pinhole_hw
        c = cfg.cam
        pose = _pose16(c2w)
        color = np.empty((H, W, 3), dtype=np.float32)
        depth = np.empty((H, W), dtype=np.float32)
        self._lib.rc_render_pinhole(
            self._handle, _fp(pose), H, W,
            ctypes.c_float(c.fx), ctypes.c_float(c.fy),
            ctypes.c_float(c.cx), ctypes.c_float(c.cy),
            _fp(color), _fp(depth))
        if not return_erp:
            return color, depth
        He, We = cfg.sim.erp_hw
        erp_color = np.empty((He, We, 3), dtype=np.float32)
        erp_dist = np.empty((He, We), dtype=np.float32)
        self._lib.rc_render_erp(
            self._handle, _fp(pose), He, We, ctypes.c_float(self.invalid),
            _fp(erp_color), _fp(erp_dist))
        return color, depth, erp_color, erp_dist

    def _to_device(self, *arrays):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def simulate(self, c2w, return_erp: bool = False):
        return self._to_device(*self.render_host(c2w, return_erp))

    def host_frame(self, c2w, quantize: bool = True):
        """The pinhole frame on the host: (uint8 colour, or f32 in [0, 1]
        without `quantize`; f32 depth). What ``frame`` copies, and what
        sim/prefetch.py's worker makes."""
        color, depth = self.render_host(c2w)
        return (quantize_color(color) if quantize else color), depth

    def frame(self, c2w):
        return self._to_device(*self.host_frame(c2w))

    def probe_erp_dist(self, c2w) -> np.ndarray:
        """Distance-only ERP render (host numpy), bit-identical to
        simulate(..., return_erp=True)[3] without the pinhole render and
        the shading; sim.probe_hw (when set) shrinks its grid."""
        He, We = self.cfg.sim.probe_hw or self.cfg.sim.erp_hw
        erp_dist = np.empty((He, We), dtype=np.float32)
        self._lib.rc_probe_erp(
            self._handle, _fp(_pose16(c2w)), He, We,
            ctypes.c_float(self.invalid), _fp(erp_dist))
        return erp_dist
