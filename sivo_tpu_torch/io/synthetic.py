"""Synthetic stereo sequence generator with exact ground truth.

A copy of the JAX package's ``sivo_tpu/io/synthetic.py`` (numpy and
OpenCV only), so that the port imports nothing of ``sivo_tpu``; it
leaves out ``structured_semantics_field`` and
``structured_semantics_device``, the JAX bench's on-device semantics
path. ``tests/test_torch_copies.py`` holds both renderers equal.

The environment has no KITTI data and the reference's CNN weights are
Git-LFS stubs, so end-to-end correctness is validated on rendered
sequences with known camera trajectories: a corridor of textured planes
(ground + walls) rendered into rectified stereo pairs via homographies
— locally planar like real scenes, so BRIEF patches are view-stable —
plus per-plane semantic class rasters. ATE against the generator's
ground truth replaces the KITTI/evo oracle described in SURVEY §6.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sivo_tpu_torch.config import CameraConfig


@dataclass
class Plane:
    p0: np.ndarray  # (3,) world origin corner
    e1: np.ndarray  # (3,) extent vector (maps texture x)
    e2: np.ndarray  # (3,) extent vector (maps texture y)
    texture: np.ndarray  # (Ht, Wt) float32
    sem_class: int  # reference Classes id


@dataclass
class SyntheticWorld:
    cam: CameraConfig
    planes: list[Plane]
    background: float = 70.0
    sky_class: int = 9  # SKY


def _make_texture(rng, h, w):
    """Realistic texture: fractal (1/f) base — structure at every
    viewing distance — plus sparse *distinctive* high-contrast elements
    (filled rectangles/discs at random scales and intensities), because
    pure self-similar noise is uniquely hostile to BRIEF descriptors
    (every neighborhood looks alike, so aliased matches survive Hamming
    gates); real scenes carry discriminative local structure."""
    import cv2

    t = np.zeros((h, w), np.float32)
    amp = 1.0
    for octave in range(5):
        step = 2 ** octave
        hh, ww = max(h // step, 2), max(w // step, 2)
        layer = rng.uniform(-1, 1, (hh, ww)).astype(np.float32)
        layer = cv2.resize(layer, (w, h), interpolation=cv2.INTER_LINEAR)
        t += amp * layer
        amp *= 1.8
    t = (t - t.min()) / (np.ptp(t) + 1e-9) * 90 + 60
    # distinctive elements, ~1 per (8px)^2 of texture. Density matters
    # twice over: pure 1/f noise is self-similar, so window-searched
    # BRIEF matches alias in the prediction direction and VO locks onto
    # a consistent false offset (measured round 1 as multiplicative
    # z-drift, and at 1-per-(16px)^2 still as an exponential
    # x1.5/frame PITCH drift — vertical self-similarity lets matches
    # track a v-shifted alias that no LM stage can observe). Real
    # imagery is full of discriminative corners; the fixture must be.
    n_elem = max((h * w) // 64, 48)
    for _ in range(n_elem):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        size = int(rng.integers(3, 20))
        val = float(rng.uniform(5, 250))
        if rng.random() < 0.5:
            ang = float(rng.uniform(0, 180))
            box = cv2.boxPoints(
                ((float(cx), float(cy)), (float(size), size * 0.6), ang)
            )
            cv2.fillPoly(t, [box.astype(np.int32)], val)
        else:
            cv2.circle(t, (int(cx), int(cy)), size // 2, val, -1)
    return np.clip(t, 0, 255)


def make_world(
    cam: CameraConfig,
    seed: int = 0,
    length: float = 160.0,
    half_width: float = 9.0,
    ground_y: float = 1.6,
    wall_height: float = 6.0,
    texel_per_m: int = 8,
) -> SyntheticWorld:
    """A corridor along +z: ground (ROAD), two side walls (BUILDING),
    end wall (BUILDING)."""
    rng = np.random.default_rng(seed)

    def tex(a_m, b_m):
        return _make_texture(
            rng, int(b_m * texel_per_m), int(a_m * texel_per_m)
        )

    w2 = half_width
    planes = [
        # ground: class ROAD (0)
        Plane(
            p0=np.array([-w2, ground_y, 0.0]),
            e1=np.array([2 * w2, 0.0, 0.0]),
            e2=np.array([0.0, 0.0, length]),
            texture=tex(2 * w2, length),
            sem_class=0,
        ),
        # left wall: BUILDING (2)
        Plane(
            p0=np.array([-w2, ground_y, 0.0]),
            e1=np.array([0.0, -wall_height, 0.0]),
            e2=np.array([0.0, 0.0, length]),
            texture=tex(wall_height, length),
            sem_class=2,
        ),
        # right wall
        Plane(
            p0=np.array([w2, ground_y, 0.0]),
            e1=np.array([0.0, -wall_height, 0.0]),
            e2=np.array([0.0, 0.0, length]),
            texture=tex(wall_height, length),
            sem_class=2,
        ),
        # end wall
        Plane(
            p0=np.array([-w2, ground_y, length]),
            e1=np.array([2 * w2, 0.0, 0.0]),
            e2=np.array([0.0, -wall_height, 0.0]),
            texture=tex(2 * w2, wall_height),
            sem_class=2,
        ),
    ]
    return SyntheticWorld(cam=cam, planes=planes)


def make_loop_world(
    cam: CameraConfig,
    seed: int = 0,
    outer: float = 13.0,
    inner: float = 6.0,
    ground_y: float = 1.6,
    wall_height: float = 6.0,
    texel_per_m: int = 16,
) -> SyntheticWorld:
    """A square ring corridor around a central block: the loop-closure
    fixture. Outer walls face inward, the inner block's walls face
    outward; driving the ring brings the camera back to its start with
    the start zone OCCLUDED for most of the lap (the inner block),
    i.e. a genuine place-recognition revisit rather than continuous
    covisibility."""
    rng = np.random.default_rng(seed)

    def tex(a_m, b_m):
        return _make_texture(
            rng, int(b_m * texel_per_m), int(a_m * texel_per_m)
        )

    def wall(x0, z0, x1, z1):
        p0 = np.array([x0, ground_y, z0])
        e1 = np.array([x1 - x0, 0.0, z1 - z0])
        ln = float(np.linalg.norm(e1))
        return Plane(
            p0=p0,
            e1=e1,
            e2=np.array([0.0, -wall_height, 0.0]),
            texture=tex(ln, wall_height),
            sem_class=2,  # BUILDING
        )

    A, B = outer, inner
    planes = [
        # ground: one big square (ROAD)
        Plane(
            p0=np.array([-A, ground_y, -A]),
            e1=np.array([2 * A, 0.0, 0.0]),
            e2=np.array([0.0, 0.0, 2 * A]),
            texture=tex(2 * A, 2 * A),
            sem_class=0,
        ),
        # outer walls
        wall(-A, -A, A, -A),
        wall(A, -A, A, A),
        wall(A, A, -A, A),
        wall(-A, A, -A, -A),
        # inner block walls
        wall(-B, -B, B, -B),
        wall(B, -B, B, B),
        wall(B, B, -B, B),
        wall(-B, B, -B, -B),
    ]
    # pillars: small free-standing facades near the walls. A view that
    # sees only one big wall is near-planar, and a planar point
    # constellation is pitch/translation-ambiguous under projection
    # (parallax ~ the constellation's DEPTH VARIANCE) — the measured
    # slow orientation creep of otherwise-healthy tracking. Real
    # streets break the degeneracy with parked cars, poles and street
    # furniture at varied depths; so does this fixture.
    def pillar(x, z, face_toward, width, height):
        # one vertical plane at (x, z), normal roughly toward the ring
        # path; painter's algorithm handles occlusion
        ux, uz = face_toward
        n = np.hypot(ux, uz) + 1e-9
        # e1 runs perpendicular to the facing direction (in-plane)
        ex, ez = -uz / n, ux / n
        p0 = np.array([x - 0.5 * width * ex, ground_y,
                       z - 0.5 * width * ez])
        return Plane(
            p0=p0,
            e1=np.array([width * ex, 0.0, width * ez]),
            e2=np.array([0.0, -height, 0.0]),
            texture=tex(width, height),
            sem_class=2,  # static street furniture / facade
        )

    # 48 pillars = one every ~4-5m of ring: the degeneracy is only
    # broken for views that actually CONTAIN off-plane structure, and
    # at 16 pillars long stretches of the lap saw none (measured:
    # rotation drift exactly zero while pillars were in view, resuming
    # the moment the view went wall-only)
    def path_clearance(x, z, half=9.5, corner_r=3.5):
        """Distance from (x, z) to the bench's rounded-square drive
        path (the corner arcs centre at (±(half-corner_r), ±...))."""
        ax, az = abs(x), abs(z)
        cc = half - corner_r
        if ax > cc and az > cc:  # corner quadrant
            return abs(np.hypot(ax - cc, az - cc) - corner_r)
        return abs(max(ax, az) - half)

    for k in range(48):
        side = k % 4  # which side of the ring
        t = -1.0 + 2.0 * ((k // 4) + rng.uniform(0.2, 0.8)) / 12.0
        along = t * (A - 1.0)
        # alternate: hugging the outer wall (facing inward) or the
        # inner block (facing outward)
        near_outer = (k % 2) == 0
        off = rng.uniform(0.4, 1.2)
        d = (A - off) if near_outer else (B + off)
        fx_, fz_ = (-1.0, 0.0) if near_outer else (1.0, 0.0)
        if side == 0:
            x, z, face = d, along, (fx_, fz_)
        elif side == 1:
            x, z, face = -d, along, (-fx_, fz_)
        elif side == 2:
            x, z, face = along, d, (fz_, fx_)
        else:
            x, z, face = along, -d, (fz_, -fx_)
        w_pillar = float(rng.uniform(0.5, 1.4))
        h_pillar = float(rng.uniform(2.0, 4.5))
        # keep the corridor drivable: a pillar ON the path turns the
        # whole view into one featureless close-up blur (zero FAST
        # keypoints -> tracking blackout, measured at two corner
        # apexes). Everything clear of the path stays — the corner
        # approaches NEED the off-plane structure (removing it
        # re-opens the planar translation ambiguity).
        if path_clearance(x, z) < 1.5:
            continue
        planes.append(pillar(
            x, z, face,
            width=w_pillar,
            height=h_pillar,
        ))
    # corner-pocket pillars: the quadrants beyond the path arcs are
    # otherwise EMPTY (wall-hugging pillars never land there), so the
    # last straight frames before each corner face only distant
    # near-planar walls — measured as an exponential y/scale alias
    # runaway (est y 0.05 -> 1.03 m over 4 frames at 500+ inliers) that
    # no kinematic gate can catch because each step is small. Close
    # off-plane structure in the approach FOV makes the alias cost
    # reprojection error and pins y/pitch through the turn, the role
    # parked cars and street furniture play at real intersections.
    cc = 9.5 - 3.5  # path arc centres (+-cc, +-cc), bench geometry
    for sx, sz in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        for j, (r0, th_deg) in enumerate(
            ((5.6, 70.0), (6.6, 40.0), (7.6, 55.0), (8.4, 20.0))
        ):
            r = r0 + rng.uniform(-0.3, 0.3)
            th = np.radians(th_deg + rng.uniform(-6.0, 6.0))
            x = sx * (cc + r * np.cos(th))
            z = sz * (cc + r * np.sin(th))
            if path_clearance(x, z) < 1.8:
                continue
            face = (-sx * np.cos(th), -sz * np.sin(th))
            planes.append(pillar(
                x, z, face,
                width=float(rng.uniform(0.8, 1.6)),
                height=float(rng.uniform(2.5, 5.0)),
            ))
    return SyntheticWorld(cam=cam, planes=planes)


def square_loop_trajectory(
    n_frames: int,
    half: float = 9.5,
    corner_r: float = 3.5,
    v_straight: float = 0.667,
    v_corner: float = 0.25,
    seed: int = 1,
    jitter: float = 0.03,
) -> np.ndarray:
    """(F, 4, 4) Tcw drive of a rounded-square circuit inside a square
    ring world: four straights (length 2*(half-corner_r)) joined by
    quarter-circle corners of radius ``corner_r``, slower in corners —
    the KITTI-urban profile (long straights, brief ~4 deg/frame turns)
    rather than a continuous-yaw circle. Extra frames past one lap
    re-drive the first straight: the loop-closure revisit."""
    rng = np.random.default_rng(seed)
    seg_straight = 2.0 * (half - corner_r)
    n_s = max(int(round(seg_straight / v_straight)), 1)
    arc_len = 0.5 * np.pi * corner_r
    n_c = max(int(round(arc_len / v_corner)), 1)
    # per-frame (speed, yaw increment) plan for one lap, tiled
    plan = []
    for _ in range(4):
        plan += [(seg_straight / n_s, 0.0)] * n_s
        plan += [(arc_len / n_c, 0.5 * np.pi / n_c)] * n_c
    pos = np.array([-half, 0.0, -(half - corner_r)])
    yaw = 0.0  # forward = [sin yaw, 0, cos yaw] (+z)
    poses = []
    i = 0
    for _ in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Twc = np.eye(4)
        Twc[:3, :3] = R
        Twc[:3, 3] = pos
        poses.append(np.linalg.inv(Twc).astype(np.float32))
        v, dyaw = plan[i % len(plan)]
        i += 1
        # jitter=0 makes laps exactly periodic (endurance bench reuses
        # one lap's rendered frames for every lap)
        v *= 1.0 + jitter * rng.standard_normal()
        # mid-step heading: rotate half, step, rotate half (keeps the
        # arc on the circle instead of spiralling out)
        yaw += 0.5 * dyaw
        pos = pos + v * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        yaw += 0.5 * dyaw
    return np.stack(poses)


def _figure8_plan(
    half: float = 9.5,
    corner_r: float = 3.5,
    sep: float = 28.0,
    v_straight: float = 0.667,
    v_corner: float = 0.25,
) -> list[tuple[float, float]]:
    """Per-frame (speed, yaw increment) plan for ONE figure-8 super-lap
    of the dumbbell world: ring-1 left straight, the long top corridor
    into ring 2, one full ring-2 lap (its top-straight re-drive is the
    first revisit), then the long bottom corridor back to ring 1's
    start (the second revisit). All 8 corners turn +90 deg, so heading
    cycles twice and chord-quantization errors cancel over the lap —
    the plan is EXACTLY periodic (endurance laps reuse one lap's
    renders)."""
    seg = 2.0 * (half - corner_r)
    long = sep + seg  # top/bottom corridors span both rings
    arc = 0.5 * np.pi * corner_r
    lengths = [seg, long, seg, seg, seg, seg, seg, long]
    plan: list[tuple[float, float]] = []
    for L in lengths:
        n_s = max(int(round(L / v_straight)), 1)
        plan += [(L / n_s, 0.0)] * n_s
        n_c = max(int(round(arc / v_corner)), 1)
        plan += [(arc / n_c, 0.5 * np.pi / n_c)] * n_c
    return plan


def _execute_plan(
    plan: list[tuple[float, float]],
    n_frames: int,
    start_pos: np.ndarray,
    start_yaw: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Integrate a (speed, dyaw) plan (tiled to n_frames) with the
    mid-step heading rule of square_loop_trajectory. Returns
    (poses_cw (F,4,4), positions (F,3))."""
    pos = np.asarray(start_pos, np.float64).copy()
    yaw = float(start_yaw)
    poses, centers = [], []
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Twc = np.eye(4)
        Twc[:3, :3] = R
        Twc[:3, 3] = pos
        poses.append(np.linalg.inv(Twc).astype(np.float32))
        centers.append(pos.copy())
        v, dyaw = plan[i % len(plan)]
        yaw += 0.5 * dyaw
        pos = pos + v * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        yaw += 0.5 * dyaw
    return np.stack(poses), np.stack(centers)


def figure8_lap_frames(**kw) -> int:
    """Frames in one figure-8 super-lap (the endurance period)."""
    return len(_figure8_plan(**kw))


def figure8_trajectory(
    n_frames: int,
    half: float = 9.5,
    corner_r: float = 3.5,
    sep: float = 28.0,
) -> np.ndarray:
    """(F, 4, 4) Tcw figure-8 drive of the dumbbell world (exactly
    periodic, no jitter — endurance laps reuse one lap's renders).
    Starts at ring 1's left straight heading +z."""
    plan = _figure8_plan(half=half, corner_r=corner_r, sep=sep)
    start = np.array([-half, 0.0, -(half - corner_r)])
    poses, _ = _execute_plan(plan, n_frames, start)
    return poses


def make_dumbbell_world(
    cam: CameraConfig,
    seed: int = 0,
    outer: float = 16.0,
    block: float = 6.0,
    sep: float = 28.0,
    half: float = 9.5,
    corner_r: float = 3.5,
    ground_y: float = 1.6,
    wall_height: float = 6.0,
    texel_per_m: int = 16,
) -> SyntheticWorld:
    """TWO square blocks inside one outer rectangle — the multi-loop
    endurance fixture. The figure-8 drive (figure8_trajectory) produces
    two DISTINCT genuine place-recognition events per exploration pass
    (ring 2's top-straight re-drive, then the return to ring 1's
    start), unlike the single-ring world whose one closure makes the
    whole map covisible. Geometry mirrors make_loop_world: walls face
    the corridors, pillars break the planar-wall pitch/translation
    ambiguity, corner pockets pin y/scale through the turns. Long
    outer walls are SPLIT into <=12 m segments so the renderer's
    center-depth painter sort stays a valid occlusion order."""
    rng = np.random.default_rng(seed)

    def tex(a_m, b_m):
        return _make_texture(
            rng, int(b_m * texel_per_m), int(a_m * texel_per_m)
        )

    def wall(x0, z0, x1, z1):
        p0 = np.array([x0, ground_y, z0])
        e1 = np.array([x1 - x0, 0.0, z1 - z0])
        ln = float(np.linalg.norm(e1))
        return Plane(
            p0=p0,
            e1=e1,
            e2=np.array([0.0, -wall_height, 0.0]),
            texture=tex(ln, wall_height),
            sem_class=2,  # BUILDING
        )

    def wall_split(x0, z0, x1, z1, seg_len=12.0):
        """Long walls in <=seg_len pieces (painter-sort correctness)."""
        ln = float(np.hypot(x1 - x0, z1 - z0))
        n = max(int(np.ceil(ln / seg_len)), 1)
        out = []
        for i in range(n):
            a, b = i / n, (i + 1) / n
            out.append(wall(
                x0 + a * (x1 - x0), z0 + a * (z1 - z0),
                x0 + b * (x1 - x0), z0 + b * (z1 - z0),
            ))
        return out

    A, B, D = outer, block, sep
    xmin, xmax, zmin, zmax = -A, D + A, -A, A
    planes = [
        Plane(  # ground (ROAD)
            p0=np.array([xmin, ground_y, zmin]),
            e1=np.array([xmax - xmin, 0.0, 0.0]),
            e2=np.array([0.0, 0.0, zmax - zmin]),
            texture=tex(xmax - xmin, zmax - zmin),
            sem_class=0,
        ),
    ]
    # outer rectangle (inward-facing), split into segments
    planes += wall_split(xmin, zmin, xmax, zmin)
    planes += wall_split(xmax, zmin, xmax, zmax)
    planes += wall_split(xmax, zmax, xmin, zmax)
    planes += wall_split(xmin, zmax, xmin, zmin)
    # the two blocks
    for cx in (0.0, D):
        planes.append(wall(cx - B, -B, cx + B, -B))
        planes.append(wall(cx + B, -B, cx + B, B))
        planes.append(wall(cx + B, B, cx - B, B))
        planes.append(wall(cx - B, B, cx - B, -B))

    # the drive path as a polyline (ACTUAL integrated positions, so
    # clearance checks see the path the bench drives, chord errors and
    # all)
    plan = _figure8_plan(half=half, corner_r=corner_r, sep=sep)
    _, path = _execute_plan(
        plan, len(plan), np.array([-half, 0.0, -(half - corner_r)])
    )
    pxz = path[:, [0, 2]]

    def clearance(x, z):
        return float(
            np.min(np.hypot(pxz[:, 0] - x, pxz[:, 1] - z))
        )

    def pillar(x, z, face_toward, width, height):
        ux, uz = face_toward
        n = np.hypot(ux, uz) + 1e-9
        ex, ez = -uz / n, ux / n
        p0 = np.array([x - 0.5 * width * ex, ground_y,
                       z - 0.5 * width * ez])
        return Plane(
            p0=p0,
            e1=np.array([width * ex, 0.0, width * ez]),
            e2=np.array([0.0, -height, 0.0]),
            texture=tex(width, height),
            sem_class=2,
        )

    def face_to_path(x, z):
        i = int(np.argmin(np.hypot(pxz[:, 0] - x, pxz[:, 1] - z)))
        fx, fz = pxz[i, 0] - x, pxz[i, 1] - z
        n = np.hypot(fx, fz) + 1e-9
        return (fx / n, fz / n)

    def scatter_along(x0, z0, x1, z1, inward, spacing=3.0):
        """Pillars offset off a wall into its corridor; keep only
        those the path actually passes (1.5 m < clearance < 6 m)."""
        ln = float(np.hypot(x1 - x0, z1 - z0))
        ux, uz = (x1 - x0) / ln, (z1 - z0) / ln
        nx, nz = inward
        d = rng.uniform(0.2, 0.8) * spacing
        while d < ln:
            off = rng.uniform(0.4, 1.2)
            x = x0 + d * ux + off * nx
            z = z0 + d * uz + off * nz
            d += spacing * rng.uniform(0.8, 1.3)
            if not (1.5 < clearance(x, z) < 6.0):
                continue
            planes.append(pillar(
                x, z, face_to_path(x, z),
                width=float(rng.uniform(0.5, 1.4)),
                height=float(rng.uniform(2.0, 4.5)),
            ))

    # outer walls (inward normals) and block walls (outward normals)
    scatter_along(xmin, zmin, xmax, zmin, (0, 1))
    scatter_along(xmax, zmin, xmax, zmax, (-1, 0))
    scatter_along(xmax, zmax, xmin, zmax, (0, -1))
    scatter_along(xmin, zmax, xmin, zmin, (1, 0))
    for cx in (0.0, D):
        scatter_along(cx - B, -B, cx + B, -B, (0, -1), spacing=2.5)
        scatter_along(cx + B, -B, cx + B, B, (1, 0), spacing=2.5)
        scatter_along(cx + B, B, cx - B, B, (0, 1), spacing=2.5)
        scatter_along(cx - B, B, cx - B, -B, (-1, 0), spacing=2.5)

    # corner pockets: off-plane structure in the approach FOV of every
    # arc (same role as make_loop_world's pocket pillars — pins y/scale
    # through the turns). Pockets sit OUTSIDE each turn: the turn
    # center is right of heading (+90 deg turns), so probe leftward.
    # midpoints of consecutive arc runs
    arc_mids = []
    run = []
    for i, (v, dy) in enumerate(plan):
        if dy != 0.0:
            run.append(i)
        elif run:
            arc_mids.append(run[len(run) // 2])
            run = []
    if run:
        arc_mids.append(run[len(run) // 2])
    for i in arc_mids:
        p = path[i]
        nxt = path[min(i + 1, len(path) - 1)]
        hx, hz = nxt[0] - p[0], nxt[2] - p[2]
        hn = np.hypot(hx, hz) + 1e-9
        hx, hz = hx / hn, hz / hn
        lx, lz = hz, -hx  # left of heading (outside the turn)
        for r0, e0 in ((2.4, 0.0), (3.4, 1.6), (4.6, -1.2), (5.6, 2.4)):
            r = r0 + rng.uniform(-0.3, 0.3)
            e = e0 + rng.uniform(-0.5, 0.5)
            x = p[0] + r * lx + e * hx
            z = p[2] + r * lz + e * hz
            if clearance(x, z) < 1.8:
                continue
            if not (xmin + 0.5 < x < xmax - 0.5):
                continue
            if not (zmin + 0.5 < z < zmax - 0.5):
                continue
            if (abs(x - 0.0) < B + 0.3 and abs(z) < B + 0.3) or (
                abs(x - D) < B + 0.3 and abs(z) < B + 0.3
            ):
                continue  # inside a block
            planes.append(pillar(
                x, z, (-lx, -lz),
                width=float(rng.uniform(0.8, 1.6)),
                height=float(rng.uniform(2.5, 5.0)),
            ))
    return SyntheticWorld(cam=cam, planes=planes)


def loop_trajectory(
    n_frames: int,
    radius: float = 9.5,
    speed: float = 1.1,
    seed: int = 1,
) -> np.ndarray:
    """(F, 4, 4) Tcw circuit: constant-speed circular drive of the ring
    (radius between inner/outer walls), camera facing along the path.
    One lap is ``2*pi*radius/speed`` frames; extra frames re-drive the
    start of the lap — the loop-closure revisit."""
    rng = np.random.default_rng(seed)
    poses = []
    theta = 0.0
    for _ in range(n_frames):
        # position on the circle; facing = the tangent direction
        # (forward = [sin yaw, 0, cos yaw] in this convention)
        x = radius * np.sin(theta)
        z = -radius * np.cos(theta)
        yaw = np.pi / 2 - theta
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Twc = np.eye(4)
        Twc[:3, :3] = R
        Twc[:3, 3] = [x, 0.0, z]
        poses.append(np.linalg.inv(Twc).astype(np.float32))
        dth = speed / radius * (1 + 0.03 * rng.standard_normal())
        theta += dth
    return np.stack(poses)


def _render_view(
    world: SyntheticWorld, Tcw: np.ndarray, right: bool, ss: int = 3
) -> tuple[np.ndarray, np.ndarray]:
    """Render one camera: returns (intensity (H, W), class raster).

    ``ss``: supersampling factor. warpPerspective point-samples under
    minification, so without it distant texture becomes frame-to-frame
    DECORRELATED pixel noise — BRIEF "matches" on it are chance
    correlations picked inside the prediction window, which biases the
    pose optimum toward the motion prediction and destabilizes VO
    (measured: multiplicative velocity runaway). Real cameras integrate
    over the pixel footprint; rendering at ss× and area-downsampling
    reproduces that."""
    import cv2

    cam = world.cam
    h, w = cam.height * ss, cam.width * ss
    K = np.array(
        [
            [cam.fx * ss, 0, cam.cx * ss + (ss - 1) / 2.0],
            [0, cam.fy * ss, cam.cy * ss + (ss - 1) / 2.0],
            [0, 0, 1],
        ]
    )
    R, t = Tcw[:3, :3].astype(np.float64), Tcw[:3, 3].astype(np.float64)
    if right:
        t = t - np.array([cam.baseline, 0.0, 0.0])

    img = np.full((h, w), world.background, np.float32)
    cls = np.full((h, w), world.sky_class, np.uint8)
    # painter's algorithm: render far planes first so near planes
    # occlude them (needed for circuit worlds where the inner block
    # hides the far side of the ring; corridor worlds are unaffected)
    def _depth(pl):
        c = pl.p0 + 0.5 * pl.e1 + 0.5 * pl.e2
        return float(np.linalg.norm(R @ c + t))

    xs_flat = None  # lazy per-view pixel grid (shared by all planes)
    for pl in sorted(world.planes, key=_depth, reverse=True):
        ht, wt = pl.texture.shape
        # cheap whole-plane reject: all four corners behind the camera
        corners = np.stack(
            [pl.p0, pl.p0 + pl.e1, pl.p0 + pl.e2, pl.p0 + pl.e1 + pl.e2]
        )
        zc_corners = corners @ R[2] + t[2]
        if (zc_corners <= 0.1).all():
            continue
        # homography: texture pixel (x, y) -> world p0 + (x/wt)e1 + (y/ht)e2
        A = np.stack(
            [pl.e1 / wt, pl.e2 / ht, pl.p0], axis=-1
        )  # (3, 3) maps [x, y, 1] -> world point
        RA = R @ A + np.outer(t, [0, 0, 1.0])
        M = K @ RA
        # backface/behind-camera handling is covered by masking below
        warped = cv2.warpPerspective(
            pl.texture, M, (w, h),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0,
        )
        # positive-depth mask: z of warped world points must be > 0
        ones = np.ones((ht, wt), np.float32)
        zmask = cv2.warpPerspective(
            ones, M, (w, h), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0.0,
        )
        cand = (zmask > 0.5) & (warped >= 0)
        idx = np.flatnonzero(cand.ravel())
        if idx.size == 0:
            continue
        # camera-frame z sign, evaluated ONLY at candidate pixels (the
        # full-image version dominated render time: ~3M pixels x 9
        # planes per view)
        if xs_flat is None:
            ys_g, xs_g = np.mgrid[0:h, 0:w]
            xs_flat = xs_g.ravel().astype(np.float64)
            ys_flat = ys_g.ravel().astype(np.float64)
        Hinv = np.linalg.inv(M)
        px = np.stack(
            [xs_flat[idx], ys_flat[idx], np.ones(idx.size)]
        )
        src = Hinv @ px
        sw = src[2]
        tex_xy = src[:2] / np.where(np.abs(sw) > 1e-12, sw, 1e-12)
        zc = RA[2, 0] * tex_xy[0] + RA[2, 1] * tex_xy[1] + RA[2, 2]
        keep = idx[zc > 0.1]
        img.ravel()[keep] = warped.ravel()[keep]
        cls.ravel()[keep] = pl.sem_class
    if ss > 1:
        img = cv2.resize(
            img, (cam.width, cam.height), interpolation=cv2.INTER_AREA
        )
        cls = cv2.resize(
            cls, (cam.width, cam.height), interpolation=cv2.INTER_NEAREST
        )
    return img, cls


def forward_trajectory(
    n_frames: int,
    speed: float = 1.0,
    yaw_rate: float = 0.002,
    seed: int = 1,
) -> np.ndarray:
    """(F, 4, 4) ground-truth Tcw sequence: forward motion with gentle
    yaw and small speed noise (camera convention: z forward)."""
    rng = np.random.default_rng(seed)
    Twc = np.eye(4)
    poses = []
    yaw = 0.0
    for _ in range(n_frames):
        poses.append(np.linalg.inv(Twc).astype(np.float32))
        yaw += yaw_rate * (1.0 + 0.1 * rng.standard_normal())
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        step = R @ np.array(
            [0, 0, speed * (1 + 0.05 * rng.standard_normal())]
        )
        Twc = Twc.copy()
        Twc[:3, 3] += step
        Twc[:3, :3] = R
    return np.stack(poses)


def render_sequence(
    world: SyntheticWorld, poses_cw: np.ndarray, ss: int = 3
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render all frames: (left (F,H,W), right (F,H,W), classes (F,H,W)).

    ``ss=2`` halves render cost vs the default 3 while still area-
    integrating 4 subsamples per pixel (enough to keep distant texture
    frame-to-frame correlated; see _render_view)."""
    lefts, rights, clss = [], [], []
    for T in poses_cw:
        l, c = _render_view(world, T, False, ss=ss)
        r, _ = _render_view(world, T, True, ss=ss)
        lefts.append(l)
        rights.append(r)
        clss.append(c)
    return np.stack(lefts), np.stack(rights), np.stack(clss)


def constant_semantics(
    h: int, w: int, cls: int = 0, confidence: float = 0.99,
    entropy: float = 0.01,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uniform static-class rasters for CNN-free pipeline tests."""
    return (
        np.full((h, w), cls, np.uint8),
        np.full((h, w), confidence, np.float32),
        np.full((h, w), entropy, np.float32),
    )


def semantics_from_classes(
    classes: np.ndarray, confidence: float = 0.99, entropy: float = 0.01
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Semantic rasters from a rendered class map."""
    return (
        classes.astype(np.uint8),
        np.full(classes.shape, confidence, np.float32),
        np.full(classes.shape, entropy, np.float32),
    )


def structured_semantics(
    classes: np.ndarray,
    seed: int = 0,
    base_entropy: float = 0.02,
    noise_entropy: float = 1.8,
    boundary_entropy: float = 3.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CNN-like semantic rasters: per-pixel classification entropy with
    spatial structure (smooth uncertainty field + inflated entropy at
    class boundaries), confidence anticorrelated with entropy.

    This matters for fidelity of the SIVO selection dynamics: the
    mutual-information term is nearly depth-independent, so with a
    CONSTANT entropy raster the criterion `MI − H > th`
    (ref: Tracking.cc:999-1002) degenerates to all-or-nothing creation
    driven purely by the pose covariance — starve/burst cycles that no
    real Bayesian SegNet posterior produces. A graded entropy field
    restores the intended behavior: confident pixels are selected
    first and creation responds smoothly as covariance grows.
    """
    import cv2

    h, w = classes.shape
    rng = np.random.default_rng(seed)
    # smooth uncertainty field in [0, 1]
    coarse = rng.uniform(0, 1, (h // 16 + 1, w // 16 + 1)).astype(
        np.float32
    )
    field = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    field = np.clip(field, 0.0, 1.0)
    # cubic skew: most pixels confident (near-zero entropy, like a real
    # posterior on easy structure), a tail of uncertain regions
    ent = base_entropy + noise_entropy * field ** 3
    # class boundaries are where a segmentation net is least certain
    edges = (
        cv2.Laplacian(classes.astype(np.float32), cv2.CV_32F) != 0
    ).astype(np.float32)
    edges = cv2.dilate(edges, np.ones((5, 5), np.float32))
    ent = np.maximum(ent, boundary_entropy * edges).astype(np.float32)
    conf = np.clip(1.0 - ent / 3.9, 0.05, 0.995).astype(np.float32)
    return classes.astype(np.uint8), conf, ent


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray) -> float:
    """Absolute trajectory error: RMSE of camera-center distances after
    least-squares SE3 (Umeyama, no scale) alignment — the SURVEY §6
    parity metric matches ``evo_ape`` semantics, whose default aligns
    trajectories globally. (First-pose-only alignment lets any initial
    sub-degree yaw error grow linearly along the path and dominate the
    reported RMSE.)"""

    def centers(T):
        return np.stack(
            [
                -(P[:3, :3].T.astype(np.float64)
                  @ P[:3, 3].astype(np.float64))
                for P in T
            ]
        )

    ce, cg = centers(est_cw), centers(gt_cw)
    mu_e, mu_g = ce.mean(0), cg.mean(0)
    H = (ce - mu_e).T @ (cg - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    ce_al = ce @ R.T + t
    return float(np.sqrt(np.mean(np.sum((ce_al - cg) ** 2, axis=-1))))
