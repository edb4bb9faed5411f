"""Main GUI of the port: config creator + pipeline launcher + volume viewer
(counterpart of ``nerfjax/gui/final_gui.py``).

  Tab 1 — config creator: edits the full scene YAML schema and round-trips it
          (``nerfjax_torch.gui.logic.generate_config_dict``).
  Tab 2 — pipeline launcher: checkboxes for the pipeline steps; runs the
          port's CLIs in turn (``logic.run_commands``) in a worker thread
          with live log output. Each CLI runs on the card by default.
  Tab 3 — volume viewer: loads volume.pth or volume_sliced.pth on a worker
          thread, embedded matplotlib 3-D scatter with point-size control,
          z-band slicing, and AABB clipping from the transforms JSON.

tkinter, its file dialogs and matplotlib are imported inside the methods
that use them.

Run: python -m nerfjax_torch.gui.final_gui
"""

from __future__ import annotations

import queue
import subprocess
import threading

import numpy as np

from nerfjax_torch.config import load_config, save_config
from nerfjax_torch.gui.logic import (
    PIPELINE_STEPS,
    aabb_band_from_transforms,
    build_pipeline_commands,
    clip_aabb_band,
    generate_config_dict,
    load_volume_any,
    run_commands,
    slice_z,
    values_from_config,
)

# Schema fields surfaced in the creator tab: (key, default, kind), those of
# nerfjax's creator. kind "ilist"/"flist" = comma-separated entry.
_CONFIG_FIELDS = [
    # identity & file layout
    ("scene_name", "my_scene", str),
    ("output_dir", "./outputs/${scene_name}", str),
    ("checkpoint_dir", "${output_dir}/checkpoints", str),
    ("transforms_json", "transforms_${scene_name}.json", str),
    ("rays_file", "${scene_name}_ray_data.npz", str),
    ("workspace", "data/${scene_name}", str),
    ("image_dir", "${workspace}/images", str),
    ("image_dir_resize", "${workspace}/images_resized", str),
    ("tmp_image_dir", "${workspace}/images_resized", str),
    ("colmap_dir", "./data/${scene_name}", str),
    ("checkpoint", "${checkpoint_dir}/nerf_final.pth", str),
    ("volume_output_path", "${output_dir}/volume.pth", str),
    ("sliced_vol_path", "${output_dir}/volume_sliced.pth", str),
    # preprocessing
    ("resize_images", False, bool),
    ("newSize", [512, 512], "ilist"),
    ("rotation", False, bool),
    ("angles", [0.0, 0.0, 0.0], "flist"),
    ("rot_order", [0, 1, 2], "ilist"),
    ("shift", [0.0, 0.0, 0.0], "flist"),
    ("scale", 0.9, float),
    ("normalization_method", "original", str),
    ("target_retention", 0.95, float),
    ("outlier_nb_neighbors", 20, int),
    ("outlier_std_ratio", 2.0, float),
    ("pb_lower", 1.0, float),
    ("pb_upper", 99.0, float),
    ("pb_padding", 0.05, float),
    # AABB
    ("remove_below_aabb", True, bool),
    ("remove_upper_aabb", True, bool),
    ("aabb_adjust_min", [0.0, 0.0, 0.0], "flist"),
    ("aabb_adjust_max", [0.0, 0.0, 0.0], "flist"),
    ("aabb_slice", True, bool),
    # model & training
    ("ngp", True, bool),
    ("nerf_type", "large", str),
    ("hidden_dim", 256, int),
    ("pos_L", 10, int),
    ("dir_L", 4, int),
    ("N_samples", 64, int),
    ("N_importance", 128, int),
    ("batch_size", 4096, int),
    ("num_epochs", 1, int),
    ("lr", 0.0005, float),
    ("white_bg", False, bool),
    ("chunk_size", 32768, int),
    ("use_memmap", False, bool),
    # extraction / viz
    ("volume_resolution", 512, int),
    ("visualize", False, bool),
]


def _parse_list(text: str, cast):
    return [cast(tok) for tok in str(text).replace(",", " ").split()]


class FinalGui:
    def __init__(self):
        import tkinter as tk
        from tkinter import ttk

        self.tk = tk
        self.root = tk.Tk()
        self.root.title("nerfjax_torch — DeepFields NeRF pipeline")
        self.root.geometry("1100x780")

        nb = ttk.Notebook(self.root)
        nb.pack(fill="both", expand=True)
        self.tab_cfg = ttk.Frame(nb)
        self.tab_run = ttk.Frame(nb)
        self.tab_view = ttk.Frame(nb)
        nb.add(self.tab_cfg, text="Config Creator")
        nb.add(self.tab_run, text="Pipeline Launcher")
        nb.add(self.tab_view, text="Volume Viewer")

        self._build_config_tab()
        self._build_launcher_tab()
        self._build_viewer_tab()

        self._log_queue: queue.Queue = queue.Queue()
        self.root.after(100, self._drain_log)

    # -- Tab 1: config creator ---------------------------------------------
    def _build_config_tab(self):
        tk, ttk = self.tk, __import__("tkinter.ttk", fromlist=["ttk"])
        frame = self.tab_cfg
        self.cfg_vars = {}
        grid = ttk.Frame(frame)
        grid.pack(side="top", fill="both", expand=True, padx=8, pady=8)
        for i, (key, default, kind) in enumerate(_CONFIG_FIELDS):
            r, c = divmod(i, 3)
            cell = ttk.Frame(grid)
            cell.grid(row=r, column=c, sticky="w", padx=6, pady=3)
            if kind is bool:
                var = tk.BooleanVar(value=default)
                ttk.Checkbutton(cell, text=key, variable=var).pack(side="left")
            elif kind in ("ilist", "flist"):
                ttk.Label(cell, text=key).pack(side="left")
                var = tk.StringVar(value=", ".join(str(v) for v in default))
                ttk.Entry(cell, textvariable=var, width=14).pack(side="left")
            else:
                ttk.Label(cell, text=key).pack(side="left")
                var = tk.StringVar(value=str(default))
                width = 26 if kind is str and "$" in str(default) else 14
                ttk.Entry(cell, textvariable=var, width=width).pack(side="left")
            self.cfg_vars[key] = (var, kind)

        btns = ttk.Frame(frame)
        btns.pack(side="bottom", pady=6)
        ttk.Button(btns, text="Save config...", command=self.save_config).pack(
            side="left", padx=4
        )
        ttk.Button(btns, text="Load config...", command=self.load_config_file).pack(
            side="left", padx=4
        )

    def gather_values(self) -> dict:
        values = {}
        for key, (var, kind) in self.cfg_vars.items():
            v = var.get()
            if kind is bool:
                values[key] = bool(v)
            elif kind == "ilist":
                values[key] = _parse_list(v, int)
            elif kind == "flist":
                values[key] = _parse_list(v, float)
            else:
                values[key] = kind(v)
        return values

    def save_config(self):
        from tkinter import filedialog

        # merge keys from a previously loaded YAML that have no creator
        # widget (occupancy_grid, precision, hash_grad_corners, ...) so
        # load -> edit -> save never silently drops them
        extras = getattr(self, "_extra_values", {})
        values = {**extras, **self.gather_values()}
        cfg = generate_config_dict(values)
        for k, v in extras.items():  # even keys the schema doesn't know
            cfg.setdefault(k, v)
        path = filedialog.asksaveasfilename(
            defaultextension=".yml", initialfile=f"{cfg['scene_name']}.yml"
        )
        if path:
            save_config(cfg, path)
            self._log(f"Saved config to {path}")
            self.cfg_path_var.set(path)

    def load_config_file(self):
        from tkinter import filedialog

        path = filedialog.askopenfilename(filetypes=[("YAML", "*.yml *.yaml")])
        if not path:
            return
        values = values_from_config(load_config(path))
        self._extra_values = {
            k: v for k, v in values.items() if k not in self.cfg_vars
        }
        for key, (var, kind) in self.cfg_vars.items():
            if key not in values or values[key] is None:
                continue
            val = values[key]
            if kind is bool:
                var.set(bool(val))
            elif kind in ("ilist", "flist"):
                var.set(", ".join(str(v) for v in val))
            else:
                var.set(str(val))
        self.cfg_path_var.set(path)
        self._log(f"Loaded config from {path}")

    # -- Tab 2: launcher -----------------------------------------------------
    def _build_launcher_tab(self):
        tk = self.tk
        from tkinter import ttk

        top = ttk.Frame(self.tab_run)
        top.pack(side="top", fill="x", padx=8, pady=6)
        ttk.Label(top, text="Config:").pack(side="left")
        self.cfg_path_var = tk.StringVar(value="")
        ttk.Entry(top, textvariable=self.cfg_path_var, width=60).pack(side="left", padx=4)
        ttk.Button(top, text="Browse...", command=self._browse_cfg).pack(side="left")

        steps_frame = ttk.Frame(self.tab_run)
        steps_frame.pack(side="top", fill="x", padx=8)
        self.step_vars = []
        for i, (label, _mod) in enumerate(PIPELINE_STEPS):
            var = tk.BooleanVar(value=False)
            ttk.Checkbutton(steps_frame, text=f"{i+1}. {label}", variable=var).grid(
                row=i // 3, column=i % 3, sticky="w", padx=6, pady=2
            )
            self.step_vars.append(var)

        ttk.Button(self.tab_run, text="Run selected steps", command=self.launch).pack(
            pady=6
        )
        self.log_text = tk.Text(self.tab_run, height=24, bg="black", fg="#8f8")
        self.log_text.pack(fill="both", expand=True, padx=8, pady=6)

    def _browse_cfg(self):
        from tkinter import filedialog

        path = filedialog.askopenfilename(filetypes=[("YAML", "*.yml *.yaml")])
        if path:
            self.cfg_path_var.set(path)

    def launch(self):
        cfg_path = self.cfg_path_var.get()
        if not cfg_path:
            self._log("No config selected.")
            return
        selected = [v.get() for v in self.step_vars]
        cmds = build_pipeline_commands(cfg_path, selected)
        if not cmds:
            self._log("No steps selected.")
            return
        threading.Thread(target=self._run_commands, args=(cmds,), daemon=True).start()

    def _run_commands(self, cmds):
        run_commands(cmds, self._log)

    def _log(self, msg: str):
        self._log_queue.put(msg)

    def _drain_log(self):
        try:
            while True:
                msg = self._log_queue.get_nowait()
                self.log_text.insert("end", msg + "\n")
                self.log_text.see("end")
        except queue.Empty:
            pass
        self.root.after(100, self._drain_log)

    # -- Tab 3: viewer --------------------------------------------------------
    def _build_viewer_tab(self):
        tk = self.tk
        from tkinter import ttk

        top = ttk.Frame(self.tab_view)
        top.pack(side="top", fill="x", padx=8, pady=6)
        ttk.Button(top, text="Load volume...", command=self._load_volume).pack(side="left")
        ttk.Label(top, text="point size").pack(side="left", padx=(12, 2))
        self.psize = tk.DoubleVar(value=2.0)
        ttk.Scale(top, from_=0.5, to=8, variable=self.psize, command=lambda _=None: self._redraw()).pack(
            side="left"
        )
        ttk.Label(top, text="z min/max").pack(side="left", padx=(12, 2))
        self.zmin = tk.DoubleVar(value=-1.0)
        self.zmax = tk.DoubleVar(value=1.0)
        for var in (self.zmin, self.zmax):
            ttk.Scale(top, from_=-1.0, to=1.0, variable=var, command=lambda _=None: self._redraw()).pack(
                side="left"
            )
        self.aabb_clip = tk.BooleanVar(value=False)
        ttk.Checkbutton(
            top, text="AABB clip", variable=self.aabb_clip, command=self._redraw
        ).pack(side="left", padx=8)

        row2 = ttk.Frame(self.tab_view)
        row2.pack(side="top", fill="x", padx=8)
        ttk.Button(
            row2, text="Load transforms JSON...", command=self._load_transforms
        ).pack(side="left")
        self.show_cube = tk.BooleanVar(value=True)
        ttk.Checkbutton(
            row2, text="unit cube", variable=self.show_cube, command=self._redraw
        ).pack(side="left", padx=6)
        self.show_axes = tk.BooleanVar(value=True)
        ttk.Checkbutton(
            row2, text="axes", variable=self.show_axes, command=self._redraw
        ).pack(side="left", padx=6)
        ttk.Label(row2, text="max points").pack(side="left", padx=(12, 2))
        self.max_points = tk.StringVar(value="500000")
        ttk.Entry(row2, textvariable=self.max_points, width=9).pack(side="left")
        ttk.Button(row2, text="Open in VisPy window", command=self._open_vispy).pack(
            side="left", padx=12
        )

        import matplotlib

        matplotlib.use("TkAgg")
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        from matplotlib.figure import Figure

        self.fig = Figure(figsize=(7, 7))
        self.ax = self.fig.add_subplot(projection="3d")
        self.canvas = FigureCanvasTkAgg(self.fig, master=self.tab_view)
        self.canvas.get_tk_widget().pack(fill="both", expand=True)
        self._points = None
        self._rgbs = None
        self._aabb = None
        self._volume_path = None

    def _load_volume(self):
        from tkinter import filedialog

        path = filedialog.askopenfilename(filetypes=[("Volume", "*.pth")])
        if not path:
            return

        def worker():
            try:
                pts, rgbs, aabb = load_volume_any(path)
                self._points, self._rgbs = pts, rgbs
                if aabb is not None:
                    self._aabb = aabb
                self._volume_path = path
                self._log(f"Loaded {len(pts):,} points from {path}")
                self.root.after(0, self._redraw)
            except Exception as e:
                self._log(f"Volume load failed: {e}")

        threading.Thread(target=worker, daemon=True).start()

    def _load_transforms(self):
        """Read the AABB clip band from a transforms JSON."""
        from tkinter import filedialog

        path = filedialog.askopenfilename(filetypes=[("JSON", "*.json")])
        if not path:
            return
        try:
            self._aabb = aabb_band_from_transforms(path)
            self._log(
                f"AABB band from {path}: "
                f"[{self._aabb['aabb_remove_below']:.3f}, "
                f"{self._aabb['aabb_remove_above']:.3f}]"
            )
            self._redraw()
        except Exception as e:
            self._log(f"Transforms load failed: {e}")

    def _open_vispy(self):
        """Hand the full (uncapped) cloud to the standalone VisPy viewer in
        a separate process so the embedded canvas stays responsive."""
        if getattr(self, "_volume_path", None) is None:
            self._log("Load a volume first.")
            return
        import sys as _sys

        subprocess.Popen(
            [_sys.executable, "-m", "nerfjax_torch.gui.open3d_gui", str(self._volume_path)]
        )
        self._log(f"Opened standalone viewer for {self._volume_path}")

    def _redraw(self):
        if self._points is None:
            return
        pts, rgbs = self._points, self._rgbs
        pts, rgbs = slice_z(pts, rgbs, self.zmin.get(), self.zmax.get())
        if self.aabb_clip.get() and self._aabb:
            pts, rgbs = clip_aabb_band(pts, rgbs, self._aabb)
        try:
            cap = max(1000, int(float(self.max_points.get())))
        except ValueError:
            cap = 500_000
        if len(pts) > cap:
            visible = len(pts)  # after z-slice / AABB clip
            idx = np.random.default_rng(0).choice(visible, cap, replace=False)
            pts, rgbs = pts[idx], rgbs[idx]
            self._log(
                f"Showing {cap:,}/{visible:,} visible points (raise 'max "
                "points' or use the VisPy window for the full cloud)"
            )
        self.ax.clear()
        self.ax.scatter(
            pts[:, 0], pts[:, 1], pts[:, 2], c=np.clip(rgbs, 0, 1),
            s=self.psize.get(), marker=".",
        )
        if self.show_cube.get():
            from nerfjax_torch.gui.viewers import _box_edges

            for s, e in _box_edges(np.full(3, -1.0), np.full(3, 1.0)):
                self.ax.plot(*zip(s, e), c="cyan", linewidth=0.6)
        if self.show_axes.get():
            for axis, color in zip(np.eye(3), ("red", "green", "blue")):
                self.ax.plot([0, axis[0]], [0, axis[1]], [0, axis[2]],
                             c=color, linewidth=1.2)
        self.ax.set_xlim(-1, 1)
        self.ax.set_ylim(-1, 1)
        self.ax.set_zlim(-1, 1)
        self.canvas.draw_idle()

    def run(self):
        self.root.mainloop()


def main():
    FinalGui().run()


if __name__ == "__main__":
    main()
