"""Point-cloud and scene previews (the port's own copy of
``nerfjax/gui/viewers.py``): ``display_pointcloud`` for ``extract_vol
--visualize`` (vispy where it is installed, else a matplotlib 3-D scatter)
and ``display_scene`` for ``colmap2nerf`` with ``visualize: true``. The
viewers' packages are imported only when a view is shown."""

from __future__ import annotations

import numpy as np


def _subsample(points, rgbs, max_points=200_000, seed=0):
    if len(points) <= max_points:
        return points, rgbs
    idx = np.random.default_rng(seed).choice(len(points), max_points, replace=False)
    return points[idx], rgbs[idx]


def display_pointcloud(
    points, rgbs, point_size: float = 2.0, title: str = "volume",
    max_points: int | None = 500_000,
):
    """Interactive scatter of a colored point cloud.

    max_points caps BOTH render paths (None = no cap — the vispy GPU
    scatter handles millions of points; matplotlib degrades above ~1M)."""
    points = np.asarray(points)
    rgbs = np.clip(np.asarray(rgbs, np.float64), 0, 1)
    if max_points is not None:
        points, rgbs = _subsample(points, rgbs, max_points=max_points)
    try:
        from vispy import app, scene  # type: ignore

        canvas = scene.SceneCanvas(keys="interactive", bgcolor="black", show=True)
        view = canvas.central_widget.add_view()
        scatter = scene.visuals.Markers()
        scatter.set_data(points, size=point_size, edge_width=0.0, face_color=rgbs)
        view.add(scatter)
        scene.visuals.XYZAxis(parent=view.scene)
        view.camera = scene.TurntableCamera(
            fov=45, azimuth=30, elevation=30, distance=4.0, center=(0, 0, 0)
        )
        app.run()
        return
    except ImportError:
        pass

    import matplotlib

    matplotlib.use(matplotlib.get_backend())
    import matplotlib.pyplot as plt

    pts, cols = points, rgbs
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cols, s=point_size, marker=".")
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(-1, 1)
    ax.set_title(title)
    plt.show()


def display_scene(points, rgbs, frames, aabb_info=None, point_size: float = 2.0):
    """Scene debug view: points + camera positions/axes + AABB box
    (reference: colmap2nerf_corrected.py:805-908 display_points)."""
    import matplotlib.pyplot as plt

    pts, cols = _subsample(np.asarray(points), np.clip(np.asarray(rgbs), 0, 1))
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cols, s=point_size, marker=".")

    for f in frames:
        T = np.asarray(f["transform_matrix"])
        pos = T[:3, 3]
        ax.scatter(*pos, c="red", s=14, marker="^")
        view = -T[:3, 2] * 0.3
        ax.plot(
            [pos[0], pos[0] + view[0]],
            [pos[1], pos[1] + view[1]],
            [pos[2], pos[2] + view[2]],
            c="yellow",
            linewidth=0.8,
        )

    if aabb_info is not None:
        lo = np.asarray(list(aabb_info["aabb_min"]), float)
        hi = np.asarray(list(aabb_info["aabb_max"]), float)
        for s, e in _box_edges(lo, hi):
            ax.plot(*zip(s, e), c="cyan", linewidth=0.7)

    ax.set_xlim(-1.5, 1.5)
    ax.set_ylim(-1.5, 1.5)
    ax.set_zlim(-1.5, 1.5)
    plt.show()


def _box_edges(lo, hi):
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    )
    pairs = [
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ]
    return [(corners[a], corners[b]) for a, b in pairs]
