"""Standalone point-cloud viewer of the port (counterpart of
``nerfjax/gui/run_gui.py``).

A minimal tkinter control panel that loads either volume .pth format and
shows it in the interactive viewer; the load runs on a worker thread.
tkinter is imported when the panel is built.

Run: python -m nerfjax_torch.gui.run_gui [volume.pth]
"""

from __future__ import annotations

import sys
import threading

from nerfjax_torch.gui.logic import load_volume_any
from nerfjax_torch.gui.viewers import display_pointcloud


class PointCloudMinimalGui:
    def __init__(self, initial_path: str | None = None):
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.root = tk.Tk()
        self.root.title("nerfjax_torch point cloud viewer")
        self.root.geometry("420x160")

        self.status = tk.StringVar(value="No volume loaded")
        ttk.Label(self.root, textvariable=self.status).pack(pady=8)
        ttk.Button(self.root, text="Load volume...", command=self.browse).pack(pady=4)
        ttk.Button(self.root, text="Show", command=self.show).pack(pady=4)

        self.psize = tk.DoubleVar(value=2.0)
        ttk.Scale(self.root, from_=0.5, to=8, variable=self.psize).pack(
            fill="x", padx=16
        )

        self._data = None
        if initial_path:
            self.load(initial_path)

    def browse(self):
        path = self.filedialog.askopenfilename(filetypes=[("Volume", "*.pth")])
        if path:
            self.load(path)

    def load(self, path: str):
        def worker():
            try:
                pts, rgbs, _ = load_volume_any(path)
                self._data = (pts, rgbs)
                self.status.set(f"{len(pts):,} points — {path}")
            except Exception as e:
                self.status.set(f"Load failed: {e}")

        threading.Thread(target=worker, daemon=True).start()

    def show(self):
        if self._data is None:
            self.status.set("Load a volume first")
            return
        pts, rgbs = self._data
        display_pointcloud(pts, rgbs, point_size=self.psize.get())

    def run(self):
        self.root.mainloop()


def main():
    initial = sys.argv[1] if len(sys.argv) > 1 else None
    PointCloudMinimalGui(initial).run()


if __name__ == "__main__":
    main()
