"""Second standalone point-cloud viewer of the port (counterpart of
``nerfjax/gui/open3d_gui.py``): a tkinter control panel that drives an
external render window (VisPy when installed, matplotlib otherwise) in a
separate process, with select/load volume, a point-size slider, Show /
Update / Close visualizer buttons and a clean shutdown. tkinter is
imported when the panel is built, the viewer's toolkit in the render
process.

Run: python -m nerfjax_torch.gui.open3d_gui [volume.pth]
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import threading

from nerfjax_torch.gui.logic import load_volume_any


def _render_proc(points, rgbs, point_size):
    """Child-process entry: block in the interactive viewer (uncapped —
    this is the full-cloud hand-off target)."""
    from nerfjax_torch.gui.viewers import display_pointcloud

    display_pointcloud(points, rgbs, point_size=point_size, max_points=None)


class PointCloudMinimalGUI:
    """Control panel: a volume must be loaded before Show; Update restarts
    the render window with the current slider value; Close terminates it."""

    def __init__(self, initial_path: str | None = None):
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.root = tk.Tk()
        self.root.title("nerfjax_torch point cloud viewer (vispy)")
        self.root.geometry("440x320")
        self.root.protocol("WM_DELETE_WINDOW", self.on_closing)

        self.status = tk.StringVar(value="No volume loaded")
        self.path_var = tk.StringVar(value=initial_path or "")

        frame = ttk.Frame(self.root, padding=10)
        frame.pack(fill="both", expand=True)
        ttk.Label(frame, textvariable=self.status).pack(pady=4)
        row = ttk.Frame(frame)
        row.pack(fill="x", pady=4)
        ttk.Entry(row, textvariable=self.path_var, width=40).pack(side="left")
        ttk.Button(row, text="Select Volume File", command=self.select_file).pack(
            side="left", padx=4
        )
        ttk.Button(frame, text="Load Volume", command=self.load_volume).pack(pady=4)

        ttk.Label(frame, text="Point size").pack()
        self.point_size_var = tk.DoubleVar(value=2.0)
        ttk.Scale(
            frame, from_=1, to=10, variable=self.point_size_var,
            command=lambda _=None: None,
        ).pack(fill="x", pady=4)

        btns = ttk.Frame(frame)
        btns.pack(pady=6)
        ttk.Button(btns, text="Show Point Cloud", command=self.show_pointcloud).pack(
            side="left", padx=4
        )
        ttk.Button(btns, text="Update Point Cloud", command=self.update_pointcloud).pack(
            side="left", padx=4
        )
        ttk.Button(btns, text="Close Point Cloud", command=self.close_visualizer).pack(
            side="left", padx=4
        )
        ttk.Button(btns, text="Close GUI", command=self.on_closing).pack(
            side="left", padx=4
        )

        self._data = None
        self._proc: mp.Process | None = None
        if initial_path:
            self.load_volume()

    # -- file handling -------------------------------------------------------
    def select_file(self):
        path = self.filedialog.askopenfilename(filetypes=[("Volume", "*.pth")])
        if path:
            self.path_var.set(path)

    def load_volume(self):
        path = self.path_var.get()
        if not path:
            self.status.set("Select a volume file first")
            return

        def worker():
            # Tk variables are not thread-safe: marshal status updates onto
            # the main loop with root.after.
            try:
                pts, rgbs, _ = load_volume_any(path)
                self._data = (pts, rgbs)
                msg = f"{len(pts):,} points — {path}"
            except Exception as e:  # noqa: BLE001 — surface in the panel
                msg = f"Load failed: {e}"
            self.root.after(0, lambda: self.status.set(msg))

        threading.Thread(target=worker, daemon=True).start()

    # -- visualizer lifecycle --------------------------------------------------
    def show_pointcloud(self):
        if self._data is None:
            self.status.set("Load a volume first")
            return
        self.close_visualizer()
        pts, rgbs = self._data
        self._proc = mp.Process(
            target=_render_proc,
            args=(pts, rgbs, float(self.point_size_var.get())),
            daemon=True,
        )
        self._proc.start()
        self.status.set("Viewer running (close its window or press Close)")

    def update_pointcloud(self):
        """Restart the render window with the current point size."""
        if self._data is None:
            self.status.set("Load a volume first")
            return
        self.show_pointcloud()

    def close_visualizer(self):
        if self._proc is not None and self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=2.0)
        self._proc = None

    def on_closing(self):
        self.close_visualizer()
        self.root.destroy()

    def run(self):
        self.root.mainloop()


def main():
    initial = sys.argv[1] if len(sys.argv) > 1 else None
    PointCloudMinimalGUI(initial).run()


if __name__ == "__main__":
    main()
