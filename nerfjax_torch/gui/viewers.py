"""Point-cloud preview (the port's own copy of ``nerfjax/gui/viewers.py:14-63``,
``display_pointcloud``, for ``extract_vol --visualize``): vispy where it is
installed, else a matplotlib 3-D scatter."""

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
