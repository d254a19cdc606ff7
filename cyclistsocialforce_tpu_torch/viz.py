"""Visualization: top-view vehicle drawings, force arrows, animation (the
port's own copy of `cyclistsocialforce_tpu.viz`; matplotlib and OpenCV
are imported only inside the functions that draw or write).

Host-side matplotlib layer with the capabilities of the reference
`vizualisation.py` (VehicleDrawing / BicycleDrawing2D / CarDrawing2D /
Arrow2D, reference vizualisation.py:25-1020) re-designed for the SoA
engine: one `SceneDrawing` renders the WHOLE population from the device
state per frame (vectorized keypoint math over agents) instead of
object-per-agent artist graphs, and plugs directly into
`Scenario.run(callback=...)`.

Components:
  - `BicycleDrawing2D`: posed top-view bike + rider (wheels, frame,
    handlebar, torso, arms, head) from (x, y, psi, delta), with a roll
    indicator that turns red beyond 45 deg (reference
    vizualisation.py:662-863).
  - `CarDrawing2D`: rotated rectangle (reference vizualisation.py:432-561).
  - `SceneDrawing`: population renderer with trajectory trails,
    destination markers, force arrows (reference VehicleDrawing,
    vizualisation.py:25-430).
  - `animate` / `write_video`: interactive animation and mp4 writeout
    (reference scenario.py:135-159, 198-223; OpenCV assembly).
  - `plot_states` / `plot_forces`: per-agent state/force time series
    (reference vehicle.py:734-917).
  - `density_map` / `plot_density`: device-side crowd occupancy /
    mean-speed heatmaps -- the mega-scale (100k-4M agent) view the
    per-agent drawing surface cannot reach (no reference counterpart).
  - `eval_force_field` / `eval_potential_field`: the fields on a grid,
    evaluated where the state lives (the card or the CPU).

Port states hold torch tensors, possibly on the card: the drawing code
reads host copies (`_host`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# evaluation points per chunk of eval_force_field: as many as keep one
# chunk's [N, points] tiles within this many pairs
FIELD_CHUNK_PAIRS = 1 << 22


def _host(a):
    """A numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)

STATE_LABELS = ["x [m]", "y [m]", "psi [rad]", "v [m/s]", "delta [rad]",
                "theta [rad]", "ddelta [rad/s]", "dtheta [rad/s]"]


def _rot(psi):
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, -s], [s, c]])


@dataclass
class BicycleDrawing2D:
    """Top-view bike + rider geometry (dimensions after the reference's
    drawing parameter defaults, parameters.py:184-364)."""

    wheel_len: float = 0.7
    wheel_width: float = 0.12
    wheelbase: float = 1.1
    handlebar_width: float = 0.55
    torso_len: float = 0.6
    torso_width: float = 0.45
    head_radius: float = 0.11
    roll_warn: float = np.pi / 4

    def keypoints(self, x, y, psi, delta):
        """Polygon sets for one agent pose; returns dict name -> [K, 2]."""
        p = np.array([x, y])
        R = _rot(psi)
        Rf = _rot(psi + delta)

        def rect(center_local, length, width, rot):
            dx, dy = length / 2, width / 2
            corners = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]])
            return (rot @ corners.T).T + (R @ center_local) + p

        rear = rect(np.array([0.0, 0.0]), self.wheel_len,
                    self.wheel_width, R)
        front_center = (R @ np.array([self.wheelbase, 0.0])) + p
        fw = np.array([[-self.wheel_len / 2, -self.wheel_width / 2],
                       [self.wheel_len / 2, -self.wheel_width / 2],
                       [self.wheel_len / 2, self.wheel_width / 2],
                       [-self.wheel_len / 2, self.wheel_width / 2]])
        front = (Rf @ fw.T).T + front_center
        frame = np.stack([p, front_center])
        hb = np.array([[0.0, -self.handlebar_width / 2],
                       [0.0, self.handlebar_width / 2]])
        handlebar = (Rf @ hb.T).T + front_center
        torso = rect(np.array([self.wheelbase * 0.25, 0.0]),
                     self.torso_len, self.torso_width, R)
        shoulder_l = (R @ np.array([self.wheelbase * 0.25 + self.torso_len
                                    / 2, self.torso_width / 2])) + p
        shoulder_r = (R @ np.array([self.wheelbase * 0.25 + self.torso_len
                                    / 2, -self.torso_width / 2])) + p
        arms = np.stack([handlebar[1], shoulder_l, shoulder_r,
                         handlebar[0]])
        head_center = (R @ np.array([self.wheelbase * 0.25
                                     + self.torso_len / 2, 0.0])) + p
        return {"rear_wheel": rear, "front_wheel": front, "frame": frame,
                "handlebar": handlebar, "torso": torso, "arms": arms,
                "head_center": head_center}

    def draw(self, ax, x, y, psi, delta, roll=0.0, color="C0"):
        """Draw one bike; returns the created artists."""
        import matplotlib.patches as mpatches

        kp = self.keypoints(x, y, psi, delta)
        warn = abs(roll) > self.roll_warn
        body_color = "red" if warn else color
        artists = []
        for name in ("rear_wheel", "front_wheel"):
            artists.append(ax.add_patch(mpatches.Polygon(
                kp[name], closed=True, facecolor="black")))
        artists += ax.plot(kp["frame"][:, 0], kp["frame"][:, 1],
                           color=body_color, linewidth=2)
        artists += ax.plot(kp["handlebar"][:, 0], kp["handlebar"][:, 1],
                           color=body_color, linewidth=2)
        artists.append(ax.add_patch(mpatches.Polygon(
            kp["torso"], closed=True, facecolor=body_color, alpha=0.8)))
        artists += ax.plot(kp["arms"][:, 0], kp["arms"][:, 1],
                           color=body_color, linewidth=1.5)
        artists.append(ax.add_patch(mpatches.Circle(
            kp["head_center"], self.head_radius, facecolor=body_color)))
        # roll indicator bubble (reference roll indicator,
        # vizualisation.py:696-863): offset scales with roll
        off = np.array([-np.sin(psi), np.cos(psi)]) * roll * 0.5
        artists.append(ax.add_patch(mpatches.Circle(
            np.array([x, y]) + off, 0.06,
            facecolor="red" if warn else "white", edgecolor="black")))
        return artists


@dataclass
class CarDrawing2D:
    """Rotated-rectangle car (reference vizualisation.py:432-561)."""

    length: float = 4.0
    width: float = 2.0

    def draw(self, ax, x, y, psi, color="C3"):
        import matplotlib.patches as mpatches

        R = _rot(psi)
        dx, dy = self.length / 2, self.width / 2
        corners = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]])
        poly = (R @ corners.T).T + np.array([x, y])
        return [ax.add_patch(mpatches.Polygon(poly, closed=True,
                                              facecolor=color, alpha=0.8))]


class Arrow2D:
    """Updateable 2D arrow, optionally projected into the ground plane
    (z = 0) of a 3D axes (reference vizualisation.py:866-1020 `Arrow2D`;
    flagged "under development" upstream -- this version fixes the
    reference's broken `update` path, whose `Line2D.set_xy` call does not
    exist, and supports animation).

    The arrow points from (x, y) to (x + dx, y + dy): a line tail plus a
    triangular head of absolute head length/width, rotated to the arrow
    direction.
    """

    def __init__(self, ax, x, y, dx, dy, headlength, headwidth,
                 proj_3d=False, **kwargs):
        self.headlength = float(headlength)
        self.headwidth = float(headwidth)
        self.proj_3d = bool(proj_3d)
        tail, head = self._keypoints(x, y, dx, dy)

        if proj_3d:
            from matplotlib.collections import PolyCollection
            from mpl_toolkits.mplot3d.art3d import Line3D

            self.vect = Line3D(tail[:, 0], tail[:, 1],
                               np.zeros_like(tail[:, 1]), **kwargs)
            self.head = PolyCollection((head,), **kwargs)
            ax.add_collection3d(self.head, zs=0)
        else:
            import matplotlib.patches as mpatches
            from matplotlib.lines import Line2D

            self.vect = Line2D(tail[:, 0], tail[:, 1], **kwargs)
            self.head = mpatches.Polygon(head, closed=True, **kwargs)
            ax.add_patch(self.head)
        ax.add_artist(self.vect)

    def _keypoints(self, x, y, dx, dy):
        """Tail segment + head triangle, head rotated to atan2(dy, dx)
        and anchored at the tip (reference calcKeypoints)."""
        ang = np.arctan2(dy, dx)
        R = _rot(ang)
        head_local = np.array([
            [0.0, -self.headlength, -self.headlength],
            [0.0, self.headwidth / 2, -self.headwidth / 2]])
        head = (R @ head_local).T + np.array([x + dx, y + dy])
        tail = np.array([[x, y], [x + dx, y + dy]])
        return tail, head

    def update(self, x, y, dx, dy, headlength=None, headwidth=None,
               **kwargs):
        """Move (and optionally restyle) the arrow in place -- works for
        both the 2D and the 3D-projected form (animatable, unlike the
        reference)."""
        if headlength is not None:
            self.headlength = float(headlength)
        if headwidth is not None:
            self.headwidth = float(headwidth)
        tail, head = self._keypoints(x, y, dx, dy)
        if self.proj_3d:
            self.vect.set_data_3d(tail[:, 0], tail[:, 1],
                                  np.zeros_like(tail[:, 1]))
            # add_collection3d(zs=0) promoted the head to a
            # Poly3DCollection: updates must carry the z column and an
            # explicit closing vertex (its projection re-uses the closed
            # path codes)
            ring = np.vstack([head, head[:1]])
            head3 = np.column_stack([ring, np.zeros(len(ring))])
            self.head.set_verts((head3,), closed=False)
        else:
            self.vect.set_data(tail[:, 0], tail[:, 1])
            # explicitly closed ring: set_xy on a closed Polygon keeps
            # stale path codes when the vertex count changes
            self.head.set_xy(np.vstack([head, head[:1]]))
        if kwargs:
            self.vect.set(**kwargs)
            self.head.set(**kwargs)


def draw_road(ax, segments):
    """Draw road geometry: filled surface polygon between the two edge
    polylines plus the edge lines on top, with the reference's styling
    (reference RoadSegment.draw_element, intersection.py:96-116:
    roadsurface_color fill, white edges at zorder 10).

    `segments` is a RoadSegmentCollection, a list of RoadSegment, or one
    RoadSegment (road.py). Returns the created artists (static scenery --
    draw once, not per frame).
    """
    from matplotlib.patches import Polygon

    if hasattr(segments, "segs"):
        segments = segments.segs
    elif not isinstance(segments, (list, tuple)):
        segments = [segments]
    artists = []
    for seg in segments:
        right, left = seg.edges
        p = seg.params
        lw = getattr(p, "roadedge_linewidth", 1.0)
        surf = Polygon(
            np.concatenate([right, left[::-1]], axis=0), closed=True,
            edgecolor=getattr(p, "roadsurface_color", (0.8, 0.8, 0.8)),
            facecolor=getattr(p, "roadsurface_color", (0.8, 0.8, 0.8)),
            linewidth=lw * 2 + 1)
        ax.add_patch(surf)
        artists.append(surf)
        for verts in (right, left):
            artists += ax.plot(
                verts[:, 0], verts[:, 1],
                color=getattr(p, "roadedge_color", "white"),
                linewidth=lw, zorder=10)
    return artists


class SceneDrawing:
    """Population renderer: bikes/cars, trails, destinations, force arrows
    (the reference's per-vehicle VehicleDrawing, vectorized); optional
    static road-geometry underlay (`road_segments`)."""

    def __init__(self, ax=None, trail_len=300, draw_forces=False,
                 car_mask=None, labels=None, road_segments=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        self.ax = ax
        self.trail_len = trail_len
        self.draw_forces = draw_forces
        self.car_mask = car_mask
        self.labels = labels
        self.bike = BicycleDrawing2D()
        self.car = CarDrawing2D()
        self._artists = []
        self._trails = None
        # static scenery: drawn once, never cleared by render()
        self.road_artists = (draw_road(self.ax, road_segments)
                             if road_segments is not None else [])

    def _clear(self):
        for a in self._artists:
            a.remove()
        self._artists = []

    def render(self, state, forces=None, traj_history=None):
        """Redraw the scene from an AgentState (host copies).

        forces: optional (fx, fy) arrays for force arrows.
        traj_history: optional [T, N, >=2] for trails.
        """
        s = _host(state.s)
        dest = _host(state.dest)
        n = s.shape[0]
        self._clear()
        for a in range(n):
            color = f"C{a % 10}"
            is_car = bool(self.car_mask[a]) if self.car_mask is not None \
                else False
            if is_car:
                self._artists += self.car.draw(self.ax, s[a, 0], s[a, 1],
                                               s[a, 2], color=color)
            else:
                self._artists += self.bike.draw(
                    self.ax, s[a, 0], s[a, 1], s[a, 2], s[a, 4],
                    roll=s[a, 5], color=color)
            # destination marker + line (reference vizualisation.py:25-430)
            self._artists += self.ax.plot(
                [s[a, 0], dest[a, 0]], [s[a, 1], dest[a, 1]],
                color=color, linestyle=":", linewidth=0.8, alpha=0.6)
            self._artists += self.ax.plot(
                dest[a, 0], dest[a, 1], marker="x", color=color)
            if self.labels is not None:
                self._artists.append(self.ax.annotate(
                    self.labels[a], (s[a, 0], s[a, 1]),
                    textcoords="offset points", xytext=(6, 6),
                    fontsize=8, color=color))
            if traj_history is not None:
                t = _host(traj_history)[-self.trail_len:, a]
                self._artists += self.ax.plot(
                    t[:, 0], t[:, 1], color=color, linewidth=1.0,
                    alpha=0.5)
            if self.draw_forces and forces is not None:
                fx, fy = _host(forces[0]), _host(forces[1])
                self._artists.append(self.ax.arrow(
                    s[a, 0], s[a, 1], float(fx[a]), float(fy[a]),
                    head_width=0.15, color=color, alpha=0.8))
        return self._artists


def animate(scenario, n_steps, interval_ms=20, draw_forces=False,
            car_mask=None, xlim=None, ylim=None):
    """Matplotlib animation of the port's Scenario (reference
    _run_animated, scenario.py:124-133): advances `scenario.chunk` steps
    per frame."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    fig, ax = plt.subplots()
    scene = SceneDrawing(ax, draw_forces=draw_forces, car_mask=car_mask)
    if xlim:
        ax.set_xlim(*xlim)
    if ylim:
        ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    frames = max(1, n_steps // scenario.chunk)
    history = []

    def frame(_):
        traj = scenario.step_chunk(record=True)
        history.append(_host(traj))
        hist = np.concatenate(history, axis=0)
        return scene.render(scenario.state, traj_history=hist)

    return FuncAnimation(fig, frame, frames=frames,
                         interval=interval_ms, blit=False, repeat=False)


def write_video(scenario, n_steps, path, fps=30, dpi=100, car_mask=None,
                xlim=None, ylim=None):
    """Render a run to mp4 via OpenCV frame assembly (reference
    _run_animated_writeout + _assemble_animation_video,
    scenario.py:135-159, 198-223)."""
    import cv2
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8), dpi=dpi)
    scene = SceneDrawing(ax, car_mask=car_mask)
    if xlim:
        ax.set_xlim(*xlim)
    if ylim:
        ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    writer = None
    history = []
    done = 0
    while done < n_steps:
        n = min(scenario.chunk, n_steps - done)
        traj = scenario.step_chunk(n, record=True)
        history.append(_host(traj))
        done += n
        hist = np.concatenate(history, axis=0)
        scene.render(scenario.state, traj_history=hist)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frame = cv2.cvtColor(buf, cv2.COLOR_RGB2BGR)
        if writer is None:
            writer = cv2.VideoWriter(
                str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                (frame.shape[1], frame.shape[0]))
        writer.write(frame)
    if writer is not None:
        writer.release()
    plt.close(fig)
    return path


def plot_states(traj, agent=0, states=(0, 1, 2, 3, 4, 5), axes=None):
    """State time series of one agent from a recorded [T, N, 8] trajectory
    (reference Vehicle.plot_states, vehicle.py:734-860)."""
    import matplotlib.pyplot as plt

    traj = _host(traj)
    if axes is None:
        _, axes = plt.subplots(len(states), 1, sharex=True)
    for ax, k in zip(np.atleast_1d(axes), states):
        ax.plot(traj[:, agent, k])
        ax.set_ylabel(STATE_LABELS[k])
    np.atleast_1d(axes)[-1].set_xlabel("step")
    return axes


def plot_forces(fx, fy, agent=0, axes=None):
    """Force time series (reference Vehicle.plot_forces,
    vehicle.py:862-917)."""
    import matplotlib.pyplot as plt

    fx, fy = _host(fx), _host(fy)
    if axes is None:
        _, axes = plt.subplots(2, 1, sharex=True)
    axes[0].plot(fx[:, agent])
    axes[0].set_ylabel("Fx (desired vx) [m/s]")
    axes[1].plot(fy[:, agent])
    axes[1].set_ylabel("Fy (desired vy) [m/s]")
    axes[1].set_xlabel("step")
    return axes


def eval_force_field(x, y, engine=None, state=None, road=None,
                     psi_recv=0.0, v_recv=0.0):
    """Total repulsive force at arbitrary evaluation points.

    Field-evaluation counterpart of the reference's
    Bicycle.calcRepulsiveForce(x, y) / RoadSegment.calcRepulsiveForce
    grid semantics (reference vehicle.py:1107-1147,
    intersection.py:226-242, used by the curve-scenario field plot,
    scenarios/curve-scenario.py:90-125): sums the fields of all ACTIVE
    agents (no FOV masking -- the raw emitted field) and of the road
    edges. The TwoD field depends on the receiver's heading; probe it
    with `psi_recv` (scalar or array).

    Evaluated in float64 where the state lives (else where the road
    does), over chunks of evaluation points (FIELD_CHUNK_PAIRS pairs a
    chunk): each point's sum over the agents is the one of the whole
    [N, M] tile the JAX package materialises.

    x, y : arrays of any (equal) shape; returns (Fx, Fy) of that shape.
    """
    shape = np.shape(x)
    rd = road if road is not None else (engine.road if engine is not None
                                        else None)
    dev = (state.device if state is not None else
           rd.vertices.device if rd is not None else "cpu")

    def flat(a):
        return torch.as_tensor(np.broadcast_to(np.asarray(
            a, dtype=np.float64), shape).ravel().copy(), device=dev)

    xf, yf = flat(x), flat(y)
    m = xf.shape[0]
    fx = torch.zeros((m,), dtype=torch.float64, device=dev)
    fy = torch.zeros((m,), dtype=torch.float64, device=dev)

    if engine is not None and state is not None \
            and engine.rep_force is not None:
        s = state.s.to(torch.float64)
        src = (s[:, 0], s[:, 1], s[:, 2], s[:, 3])
        w = state.active.to(torch.float64)[:, None]
        pr, vr = flat(psi_recv), flat(v_recv)
        step = max(1, FIELD_CHUNK_PAIRS // max(state.n, 1))
        for lo in range(0, m, step):
            hi = min(m, lo + step)
            fpx, fpy = engine.rep_force(engine.params, src,
                                        (xf[lo:hi], yf[lo:hi], pr[lo:hi],
                                         vr[lo:hi]))
            fx[lo:hi] += torch.sum(fpx * w, dim=0)
            fy[lo:hi] += torch.sum(fpy * w, dim=0)

    if rd is not None:
        from cyclistsocialforce_tpu_torch.ops.forces import road_edge_force

        rd = rd.to(torch.float64, dev)
        rx, ry = road_edge_force(xf, yf, rd.vertices, rd.weights,
                                 rd.F_0, rd.sigma)
        fx, fy = fx + rx, fy + ry
    return _host(fx).reshape(shape), _host(fy).reshape(shape)


def plot_force_field(xlim, ylim, engine=None, state=None, road=None,
                     axes=None, grid_step=0.1, quiver_step=1.0,
                     f_clip=5.0, slice_y=None, psi_recv=0.0):
    """Force-field figure after the reference curve scenario
    (scenarios/curve-scenario.py:90-125): filled contours of the clamped
    force magnitude, a white quiver overlay on a coarser grid, and an
    optional 1-D magnitude slice along y = slice_y.

    Returns the axes (one or two, matching the reference's 1x2 layout
    when slice_y is given)."""
    import matplotlib.pyplot as plt

    if axes is None:
        n_ax = 2 if slice_y is not None else 1
        _, axes = plt.subplots(1, n_ax, squeeze=False)
        axes = axes[0]
    ax0 = np.atleast_1d(axes)[0]
    ax0.set_aspect("equal")

    gx, gy = np.meshgrid(np.arange(xlim[0], xlim[1], grid_step),
                         np.arange(ylim[0], ylim[1], grid_step))
    fx, fy = eval_force_field(gx, gy, engine=engine, state=state,
                              road=road, psi_recv=psi_recv)
    fmag = np.minimum(np.hypot(fx, fy), f_clip)
    ax0.contourf(gx, gy, fmag)

    qx, qy = np.meshgrid(np.arange(xlim[0], xlim[1], quiver_step),
                         np.arange(ylim[0], ylim[1], quiver_step))
    qfx, qfy = eval_force_field(qx, qy, engine=engine, state=state,
                                road=road, psi_recv=psi_recv)
    ax0.quiver(qx, qy, qfx, qfy, color="white")
    ax0.set_xlim(*xlim)
    ax0.set_ylim(*ylim)

    if slice_y is not None:
        ax1 = np.atleast_1d(axes)[1]
        sx = np.arange(xlim[0], xlim[1], grid_step)
        sfx, sfy = eval_force_field(sx, np.full_like(sx, slice_y),
                                    engine=engine, state=state, road=road,
                                    psi_recv=psi_recv)
        ax1.plot(sx, np.minimum(np.hypot(sfx, sfy), 2 * f_clip))
        ax1.set_xlabel("x [m]")
        ax1.set_ylabel("|F|")
    return axes


def eval_potential_field(x, y, state, params, agent=None):
    """Legacy elliptic repulsive POTENTIAL of one agent (or the sum over
    active agents) at arbitrary points -- the field-evaluation counterpart
    of Bicycle.calcPotential (reference vehicle.py:1066-1104); float64,
    where the state lives."""
    from cyclistsocialforce_tpu_torch.ops.forces import potential_legacy
    from cyclistsocialforce_tpu_torch.params import pair_hi

    shape = np.shape(x)
    dev = state.device
    xf = torch.as_tensor(np.ravel(x), dtype=torch.float64, device=dev)
    yf = torch.as_tensor(np.ravel(y), dtype=torch.float64, device=dev)
    s = state.s.to(torch.float64)
    idx = torch.as_tensor(np.arange(state.n) if agent is None
                          else np.atleast_1d(agent), device=dev)
    n = idx.numel()

    def b(v):
        v = torch.as_tensor(v, dtype=torch.float64, device=dev)
        return v.expand((state.n,))[idx][:, None]

    dx = xf[None, :] - s[idx, 0][:, None]
    dy = yf[None, :] - s[idx, 1][:, None]
    P = potential_legacy(dx, dy, s[idx, 2][:, None], s[idx, 3][:, None],
                         b(pair_hi(params.v_max_riding)), b(params.p_0),
                         b(params.p_decay))
    if agent is None:
        w = state.active.to(torch.float64)[idx][:, None]
        return _host(torch.sum(P * w, dim=0)).reshape(shape)
    if n == 1:
        return _host(P[0]).reshape(shape)
    return _host(P).reshape((n,) + shape)


def density_map(x, y, xlim, ylim, bins=512, values=None, active=None,
                device="cuda"):
    """Device-side 2-D crowd histogram: per-cell agent counts (or the
    per-cell MEAN of a per-agent quantity) over (xlim, ylim).

    Per-agent drawings (SceneDrawing, the reference's VehicleDrawing
    surface) stop being readable -- and affordable -- beyond a few
    hundred agents; this is the mega-scale view for the 100k-4M
    populations this engine runs. The cells are counted on the device
    (`bincount`), so only the [bins, bins] image crosses to the host.
    The reference has no counterpart (its scenarios top out at tens of
    agents, reference scenario.py:96-113).

    Args:
      x, y: [N] agent positions: tensors (computed on their device) or
        arrays (moved to `device`).
      xlim, ylim: (lo, hi) map bounds; agents outside are dropped.
      bins: int or (nx, ny) cell counts.
      values: optional [N] per-agent quantity (e.g. speed `state.s[:, 3]`);
        the map then holds its per-cell mean over present agents
        (empty cells are 0), summed in float32 by `index_add_`.
      active: optional [N] bool mask; False rows (padding agents) are
        excluded.

    The counts are exact. On the CPU the float32 sums of `values` add in
    agent order, as the JAX package's scatter does; on CUDA they are
    atomic adds in no fixed order, so a mean agrees within float32
    rounding.

    Returns (H, extent): H a [ny, nx] float32 array (row i = y cell i),
    extent = (x0, x1, y0, y1) -- imshow-ready with origin="lower".
    """
    nx, ny = (bins, bins) if isinstance(bins, int) else bins
    x0, x1 = map(float, xlim)
    y0, y1 = map(float, ylim)
    if isinstance(x, torch.Tensor):
        device = x.device
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    ix = torch.clamp(((x - x0) * (nx / (x1 - x0))).to(torch.int32), 0,
                     nx - 1)
    iy = torch.clamp(((y - y0) * (ny / (y1 - y0))).to(torch.int32), 0,
                     ny - 1)
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if active is not None:
        inside = inside & torch.as_tensor(active, device=device)
    flat = (iy.long() * nx + ix.long())[inside]
    counts = torch.bincount(flat, minlength=ny * nx).to(torch.float32)
    if values is not None:
        v = torch.as_tensor(values, device=device).to(torch.float32)
        sums = torch.zeros(ny * nx, dtype=torch.float32,
                           device=device).index_add_(0, flat, v[inside])
        H = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                        0.0)
    else:
        H = counts
    return _host(H).reshape(ny, nx), (x0, x1, y0, y1)


def plot_density(state, xlim=None, ylim=None, bins=512, quantity="count",
                 ax=None, cmap="magma", log=True, colorbar=True):
    """Heatmap of a (mega-scale) population: agent count or mean speed
    per cell (imshow of `density_map`).

    quantity: "count" (log-normed occupancy by default) or "speed"
    (per-cell mean of `state.s[:, 3]`, linear). Bounds default to the
    active agents' bounding box. Returns the AxesImage.
    """
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    s = state.s
    act = _host(state.active)
    if xlim is None or ylim is None:
        xh = _host(s[:, 0])[act]
        yh = _host(s[:, 1])[act]
        xlim = xlim or (float(xh.min()), float(xh.max()))
        ylim = ylim or (float(yh.min()), float(yh.max()))
    values = s[:, 3] if quantity == "speed" else None
    H, extent = density_map(s[:, 0], s[:, 1], xlim, ylim, bins=bins,
                            values=values, active=state.active)
    if ax is None:
        _, ax = plt.subplots()
    norm = (LogNorm(vmin=1, vmax=max(H.max(), 1.0))
            if (log and quantity == "count") else None)
    im = ax.imshow(H, origin="lower", extent=extent, norm=norm,
                   cmap=cmap, aspect="equal",
                   interpolation="nearest")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if colorbar:
        label = ("agents / cell" if quantity == "count"
                 else "mean speed [m/s]")
        ax.figure.colorbar(im, ax=ax, label=label)
    return im


def plot_fft(t, x, axes=None):
    """Time series + single-sided FFT magnitude plot of an equally
    spaced signal (reference utils.py:15-53, a control-loop debugging
    aid). `t` is either the [N] time-sample array or the scalar sample
    time t_s; returns the two axes (signal on top, log-magnitude
    spectrum below)."""
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    n = len(x)
    if np.ndim(t) == 0:
        t_s = float(t)
        t = np.arange(n) * t_s
    else:
        t = np.asarray(t)
        t_s = float(t[1] - t[0])
    X = np.fft.fft(x) / n                       # forward-normalized
    freqs = np.fft.fftfreq(n, t_s)
    half = n // 2
    if axes is None:
        _, axes = plt.subplots(2, 1)
    axes[0].plot(t, x)
    axes[0].set_xlabel("t [s]")
    axes[1].plot(freqs[:half], np.abs(X[:half]))
    axes[1].set_xlabel("f [Hz]")
    axes[1].set_yscale("log")
    return axes


def fig_to_img(fig):
    """Rasterize a matplotlib figure to an [H, W, 4] uint8 RGBA array
    (reference utils.figToImg, utils.py:89-98) -- used to hand frames to
    video writers without touching the screen."""
    import io

    with io.BytesIO() as buff:
        fig.savefig(buff, format="raw")
        buff.seek(0)
        data = np.frombuffer(buff.getvalue(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape((int(h), int(w), -1))


def clear_axes(ax):
    """Remove every artist from an axes (reference utils.clearAxes,
    utils.py:109-111) -- frame reset for redraw-from-scratch animation
    loops."""
    for artist in list(ax.get_children()):
        try:
            artist.remove()
        except NotImplementedError:
            pass        # axis spines/titles that refuse removal


def plot_gridsearch(info, axes=None):
    """Grid-search model-selection plot (reference
    PoleModel.plot_gridsearch, controlbehavior.py:1653-1688): one panel
    per metric (BIC/AIC/NLL), score vs n_components with one line per
    covariance type and the selected model marked. `info` is the dict
    returned by gmm_fit.fit_optimize."""
    import matplotlib.pyplot as plt

    results = info["gridsearch"]
    cov_types = sorted({r["cov_type"] for r in results})
    metrics = ("BIC", "AIC", "NLL")
    if axes is None:
        _, axes = plt.subplots(1, len(metrics), layout="constrained")
    best_k = info["hyperparameters"]["n_components"]
    for metric, ax in zip(metrics, axes):
        for ctype in cov_types:
            rows = sorted((r for r in results if r["cov_type"] == ctype),
                          key=lambda r: r["n_components"])
            ax.plot([r["n_components"] for r in rows],
                    [r[metric] for r in rows], label=ctype)
        ax.plot([best_k], [info["scores_val"][metric]], marker="o",
                color="tab:red")
        ax.annotate(f"{info['scores_val'][metric]:.2f}",
                    xy=(best_k, info["scores_val"][metric]),
                    horizontalalignment="left",
                    verticalalignment="bottom")
        ax.set_title(metric)
        ax.set_xlabel("n_components")
        ax.set_ylabel("score")
    axes[0].legend()
    return axes


def plot_marginals(gmm, X_train=None, X_test=None, marginals_2d=True,
                   marginals_1d=True, n_grid=80):
    """Marginal-distribution diagnostics of a fitted mixture (reference
    PoleModel.plot_marginals, controlbehavior.py:1700-1830): 1D marginal
    pdf curves per feature (data histogram underneath) and pairwise 2D
    marginal pdf contours with train/test scatter overlays. `gmm` is a
    behavior.GMMData; returns the created figures."""
    import matplotlib.pyplot as plt

    f = gmm.n_features
    figs = []

    def lims(idx):
        pts = [gmm.means[:, idx]]
        for X in (X_train, X_test):
            if X is not None:
                pts.append(np.asarray(X)[:, idx])
        allv = np.concatenate(pts)
        pad = 0.2 * (allv.max() - allv.min() + 1e-9)
        return float(allv.min() - pad), float(allv.max() + pad)

    if marginals_2d and f >= 2:
        pairs = [(i, j) for i in range(f) for j in range(i + 1, f)]
        ncol = min(len(pairs), 4)
        nrow = int(np.ceil(len(pairs) / ncol))
        fig, axes = plt.subplots(nrow, ncol, squeeze=False,
                                 layout="constrained")
        for ax, (i, j) in zip(axes.ravel(), pairs):
            xl, yl = lims(i), lims(j)
            pts, pdf = gmm.marginal_pdf_2d(xl, yl, i, j,
                                           n_samples=n_grid)
            gx = pts[:, 0].reshape(n_grid, n_grid)
            gy = pts[:, 1].reshape(n_grid, n_grid)
            ax.contour(gx, gy, pdf.reshape(n_grid, n_grid), levels=8)
            for X, style in ((X_train, dict(s=5, color="black")),
                             (X_test, dict(s=5, color="tab:pink"))):
                if X is not None:
                    X = np.asarray(X)
                    ax.scatter(X[:, i], X[:, j], **style)
            ax.scatter(gmm.means[:, i], gmm.means[:, j], s=12,
                       color="tab:red")
            ax.set_xlabel(f"f{i}")
            ax.set_ylabel(f"f{j}")
        for ax in axes.ravel()[len(pairs):]:
            ax.set_axis_off()
        figs.append(fig)

    if marginals_1d:
        ncol = min(f, 8)
        nrow = int(np.ceil(f / ncol))
        fig, axes = plt.subplots(nrow, ncol, squeeze=False,
                                 layout="constrained")
        for idx, ax in zip(range(f), axes.ravel()):
            xl = lims(idx)
            xs, pdf = gmm.marginal_pdf_1d_range(xl, idx,
                                                n_samples=4 * n_grid)
            for X, color in ((X_train, "black"), (X_test, "tab:pink")):
                if X is not None:
                    ax.hist(np.asarray(X)[:, idx], bins=30, density=True,
                            alpha=0.3, color=color)
            ax.plot(xs, pdf)
            ax.set_xlabel(f"f{idx}")
        for ax in axes.ravel()[f:]:
            ax.set_axis_off()
        figs.append(fig)
    return figs
