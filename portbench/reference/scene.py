"""The plain reference's scenes, rebuilt from a configuration file alone.

A scene is a list of rows (one surface each) and a disk source. Every row
is a rectangle in its local xy plane or a paraboloid z = (x^2 + y^2) /
(4 f) trimmed to 0 <= z <= h, placed by a 4 x 4 local-to-world frame. The
geometry follows the upstream Tracer's definitions (casselineau/Tracer):
its rotation_to_z frame, its azimuth-elevation heliostat kinematics and
its MiniDish assembly, written again here in NumPy.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Row:
    name: str
    kind: str                  # "rect" or "parab"
    frame: np.ndarray          # (4, 4) local -> world
    size: tuple                # rect: (width, height); parab: (a, z_max)
    absorptivity: float
    slope_sigma: float = 0.0   # bivariate tan-Gaussian normal error [rad]
    one_sided: bool = False    # energy of a hit along local +z is absorbed


@dataclasses.dataclass
class Source:
    centre: np.ndarray         # (3,)
    direction: np.ndarray      # (3,) unit, the rays' mean direction
    radius: float
    dni: float                 # W/m^2
    sunshape: str              # "buie" or "pillbox"
    csr: float = 0.0           # buie: circumsolar ratio, as calibrated
    half_angle: float = 0.0    # pillbox: cap half-angle [rad]

    def ray_energy(self, rays_per_source: int) -> float:
        """Energy of one ray when ``rays_per_source`` rays carry the
        source's whole power."""
        return self.dni * math.pi * self.radius ** 2 / rays_per_source


@dataclasses.dataclass
class Scene:
    rows: list
    source: Source
    receiver: str              # the row whose flux map is compared


def rotation_to_z(v) -> np.ndarray:
    """Upstream's rotation_to_z: columns (x, y, z) with z = v and x in
    the world xy plane."""
    v = np.asarray(v, dtype=float)
    perp = np.array([v[1], -v[0], 0.0])
    if not perp.any():
        perp = np.array([1.0, 0.0, 0.0])
    perp /= np.linalg.norm(perp)
    return np.stack([perp, np.cross(v, perp), v], axis=1)


def axis_rotation(axis, angle: float) -> np.ndarray:
    """Right-handed rotation by ``angle`` about the unit ``axis``."""
    a = np.asarray(axis, dtype=float)
    s, c = math.sin(angle), math.cos(angle)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                  [-a[1], a[0], 0.0]])
    return np.outer(a, a) * (1.0 - c) + np.eye(3) * c + k * s


def homog(rot=None, shift=(0.0, 0.0, 0.0)) -> np.ndarray:
    out = np.eye(4)
    if rot is not None:
        out[:3, :3] = rot
    out[:3, 3] = shift
    return out


def sun_vector(azimuth: float, zenith: float) -> np.ndarray:
    """Unit vector towards the sun; azimuth clockwise from North (+y)."""
    return np.array([math.sin(zenith) * math.sin(azimuth),
                     math.sin(zenith) * math.cos(azimuth),
                     math.cos(zenith)])


def calibrated_csr(csr: float) -> float:
    """The CSR calibration that upstream applies before Buie's profile."""
    if csr <= 0.1:
        return (-2.245e3 * csr ** 4 + 5.207e2 * csr ** 3
                - 3.939e1 * csr ** 2 + 1.891 * csr + 8e-3)
    return (1.973 * csr ** 4 - 2.481 * csr ** 3 + 0.607 * csr ** 2
            + 1.151 * csr - 0.020)


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def load_pads(cfg: dict) -> np.ndarray:
    pads = np.loadtxt(ROOT / cfg["pads_file"], delimiter=",", ndmin=2)
    return pads[:cfg["heliostats"]["count"]]


def heliostat_field(cfg: dict) -> Scene:
    pads = load_pads(cfg)
    hel, sun_cfg = cfg["heliostats"], cfg["sun"]
    sun = sun_vector(sun_cfg["azimuth_rad"], sun_cfg["zenith_rad"])
    aim = np.array([0.0, 0.0, cfg["tower"]["aim_height_m"]])
    rows = []
    for i, p in enumerate(pads):
        to_aim = (aim - p) / np.linalg.norm(aim - p)
        normal = (sun + to_aim) / np.linalg.norm(sun + to_aim)
        primary = math.atan2(normal[1], normal[0]) + math.pi / 2.0
        tilt = math.acos(min(max(normal[2], -1.0), 1.0))
        rot = (axis_rotation([0.0, 0.0, 1.0], primary)
               @ axis_rotation([1.0, 0.0, 0.0], tilt))
        rows.append(Row(f"heliostat_{i}", "rect", homog(rot, p),
                        (hel["width_m"], hel["height_m"]),
                        hel["absorptivity"], hel["slope_error_rad"],
                        hel["one_sided"]))
    rec = cfg["receiver"]
    centre = pads.mean(axis=0)
    facing = np.array([centre[0], centre[1],
                       -rec["normal_toward_depth_factor"]
                       * cfg["tower"]["aim_height_m"]])
    facing /= np.linalg.norm(facing)
    rows.append(Row("receiver", "rect",
                    homog(rotation_to_z(facing),
                          (0.0, 0.0, rec["centre_height_m"])),
                    (rec["width_m"], rec["height_m"]), rec["absorptivity"],
                    0.0, rec["one_sided"]))
    disk = cfg["source_disk"]
    radius = float(np.max(np.hypot(pads[:, 0] - centre[0],
                                   pads[:, 1] - centre[1]))
                   + disk["margin_m"])
    csr = sun_cfg["csr"]
    if sun_cfg.get("csr_calibrated"):
        csr = calibrated_csr(csr)
    source = Source(centre + sun * disk["distance_m"], -sun, radius,
                    sun_cfg["dni_w_m2"], "buie", csr=csr)
    return Scene(rows, source, "receiver")


def minidish(cfg: dict) -> Scene:
    dish, rec, hom = cfg["dish"], cfg["receiver"], cfg["homogenizer"]
    tilt = homog(axis_rotation([1.0, 0.0, 0.0], cfg["tilt_about_x_rad"]))
    radius = dish["diameter_m"] / 2.0
    a = 1.0 / (4.0 * dish["focal_length_m"])
    rows = [Row("dish", "parab", tilt, (a, a * radius ** 2),
                1.0 - dish["optical_efficiency"])]
    sx, sy = rec["side_m"], rec["side_m"] * rec["aspect"]
    rec_frame = tilt @ homog(axis_rotation([1.0, 0.0, 0.0], math.pi),
                             (0.0, 0.0, rec["position_m"]))
    rows.append(Row("receiver", "rect", rec_frame, (sx, sy),
                    rec["absorptivity"], 0.0, rec["one_sided"]))
    depth, absorb = hom["depth_m"], 1.0 - hom["optical_efficiency"]
    y_axis, x_axis = [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]
    walls = (("homog_xp", (depth, sy), (sx / 2, 0.0), y_axis, -math.pi / 2),
             ("homog_xn", (depth, sy), (-sx / 2, 0.0), y_axis, math.pi / 2),
             ("homog_yp", (sx, depth), (0.0, sy / 2), x_axis, math.pi / 2),
             ("homog_yn", (sx, depth), (0.0, -sy / 2), x_axis, -math.pi / 2))
    for name, size, (x, y), axis, angle in walls:
        frame = rec_frame @ homog(axis_rotation(axis, angle),
                                  (x, y, depth / 2.0))
        rows.append(Row(name, "rect", frame, size, absorb, 0.0,
                        hom["one_sided"]))
    sun = cfg["sun"]
    direction = np.asarray(sun["direction"], dtype=float)
    source = Source(np.asarray(sun["centre_m"], dtype=float),
                    direction / np.linalg.norm(direction), sun["radius_m"],
                    sun["dni_w_m2"], "pillbox",
                    half_angle=sun["half_angle_rad"])
    return Scene(rows, source, "receiver")


BUILDERS = {"heliostat_field": heliostat_field, "minidish": minidish}


def build(cfg: dict) -> Scene:
    return BUILDERS[cfg["kind"]](cfg)
