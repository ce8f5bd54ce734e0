"""Qt GUI (optional, requires PyQt5): the port's copy of
``torchpiv_tpu/gui/app.py`` on the port's ``PIVRunner``, ``OnlinePIV``,
``VideoPIV``, ``Database``, ``PIVParams`` and persistence.  The Device box
lists the port's device names (``cpu``, ``cuda``, ``cuda:<i>``) and starts
on the settings' device where the box has it, else on the card where there
is one: the port's entry points run on the card unless asked for the CPU.

Functional equivalent of the reference's GUI layer (``mainWindow.py``,
``PIVwidgets.py``, ``ControlsWidgets.py``), re-composed
around this package's headless pieces: the settings form edits ``PIVParams``,
Start spins a ``PIVRunner`` on a QThread (progress/output/finished/failed
re-emitted as Qt signals), a repaint timer refreshes the live field view
(2 s, like mainWindow.py:35-38), results land in the shared ``Database``,
and the plotting itself is ``gui.viz`` on embedded matplotlib canvases.
A global excepthook routes worker exceptions into a message box
(mainWindow.py:203-256).
"""
from __future__ import annotations

import sys
import traceback

import numpy as np

from ..pipeline import DeviceMap, PIVRunner
from ..utils.config import PIVParams
from ..utils.database import Database
from ..utils.persistence import make_name, save_table
from . import viz

try:  # pragma: no cover - exercised only where PyQt5 exists
    from PyQt5 import QtCore, QtWidgets
    from matplotlib.backends.backend_qt5agg import (
        FigureCanvasQTAgg,
        NavigationToolbar2QT,
    )
    from matplotlib.figure import Figure

    HAVE_QT = True
except Exception:  # pragma: no cover
    HAVE_QT = False


def require_qt():
    if not HAVE_QT:
        raise ImportError(
            "PyQt5 (and the matplotlib Qt backend) are required for the GUI; "
            "install with `pip install torchpiv-tpu[gui]` or use the "
            "`tpiv-torch` CLI for headless operation."
        )


if HAVE_QT:  # pragma: no cover - GUI code paths need a display + PyQt5

    class WorkerBridge(QtCore.QObject):
        """Runs a PIVRunner (or any callable) on a thread, bridging
        callbacks to Qt signals."""

        finished = QtCore.pyqtSignal(dict)
        progress = QtCore.pyqtSignal(int)
        output = QtCore.pyqtSignal(dict)
        failed = QtCore.pyqtSignal()

        def __init__(self, params: PIVParams = None, target=None,
                     **runner_kwargs):
            super().__init__()
            self.runner = None
            self._target = target
            self._stopper = None  # targets may register a stop callable
            if params is not None:
                self.runner = PIVRunner(
                    params,
                    on_progress=self.progress.emit,
                    on_output=self.output.emit,
                    on_finished=self.finished.emit,
                    on_failed=self.failed.emit,
                    **runner_kwargs,
                )

        def stop(self):
            if self.runner is not None:
                self.runner.stop()
            if self._stopper is not None:
                self._stopper()

        @QtCore.pyqtSlot()
        def run(self):
            try:
                if self._target is not None:
                    self._target(self)
                else:
                    self.runner.run()
            except Exception:
                traceback.print_exc()
                self.failed.emit()

    class FieldCanvas(FigureCanvasQTAgg):
        """Live 2-D field view (reference PIVcanvas, PIVwidgets.py:106-251)."""

        def __init__(self):
            self.fig = Figure(figsize=(6, 5))
            super().__init__(self.fig)
            self.ax = self.fig.add_subplot(111)
            self.key = "Vy[m/s]"
            self.vmin = self.vmax = None
            self.streamlines = False
            self.vectors = False
            self.show_grid = False
            self.show_axes = True
            self.profile_index = 0
            self.profile_horizontal = True
            self.show_profile_line = True
            # movable profile line (reference PIVwidgets.py:125-157): click
            # or drag on the field snaps the white line (and the profile
            # plot) to the nearest row/column; the owner registers a
            # callback so the slider stays in sync.
            self.on_profile_moved = None
            self.mpl_connect("button_press_event", self._on_mouse)
            self.mpl_connect("motion_notify_event", self._on_mouse)

        def _on_mouse(self, event):
            if (event.inaxes is not self.ax or event.button != 1
                    or not self.show_profile_line):
                return
            data = Database().get()
            if not data or "x[mm]" not in data:
                return
            x = np.asarray(data["x[mm]"])
            y = np.asarray(data["y[mm]"])
            if self.profile_horizontal:
                if event.ydata is None:
                    return
                idx = int(np.abs(y[:, 0] - event.ydata).argmin())
            else:
                if event.xdata is None:
                    return
                idx = int(np.abs(x[0, :] - event.xdata).argmin())
            if idx != self.profile_index:
                if self.on_profile_moved is not None:
                    self.on_profile_moved(idx)
                else:
                    self.profile_index = idx
                    self.redraw()

        def redraw(self):
            data = Database().get()
            if not data or self.key not in data:
                return
            self.fig.clf()
            self.ax = self.fig.add_subplot(111)
            prof = (
                (self.profile_index, self.profile_horizontal)
                if self.show_profile_line
                else None
            )
            viz.render_field(
                data,
                self.key,
                vmin=self.vmin,
                vmax=self.vmax,
                streamlines=self.streamlines,
                vectors=self.vectors,
                profile=prof,
                show_grid=self.show_grid,
                show_axes=self.show_axes,
                ax=self.ax,
            )
            self.draw_idle()

    class ProfileCanvas(FigureCanvasQTAgg):
        """1-D profile plot (reference ProfileCanvas, PIVwidgets.py:44-103)."""

        def __init__(self):
            self.fig = Figure(figsize=(6, 2.5))
            super().__init__(self.fig)
            self.ax = self.fig.add_subplot(111)
            self.key = "Vy[m/s]"
            self.index = 0
            self.horizontal = True

        def redraw(self):
            data = Database().get()
            if not data or self.key not in data:
                return
            field = np.asarray(data[self.key])
            idx = min(
                self.index,
                (field.shape[0] if self.horizontal else field.shape[1]) - 1,
            )
            coords, values = viz.extract_profile(data, self.key, idx, self.horizontal)
            self.ax.clear()
            self.ax.plot(coords, values)
            self.ax.set_ylabel(self.key)
            viz.autoscale_y(self.ax)
            self.draw_idle()

        def save_profile(self):
            data = Database().get()
            if not data or self.key not in data:
                return
            coords, values = viz.extract_profile(
                data, self.key, self.index, self.horizontal
            )
            fname, save_dir = make_name(Database().name or "field", self.key,
                                        self.horizontal)
            save_table(fname, save_dir, {"coord": coords, self.key: values})

    class SettingsForm(QtWidgets.QGroupBox):
        """Analysis settings (reference Settings, ControlsWidgets.py:59-310)."""

        FORMATS = [".bmp", ".tif", ".tiff", ".png", ".jpg", ".jpeg", ".pgm", ".dib"]
        SAVE_OPTS = ["Dont save", "Save statistics", "Save all text",
                     "Save all binary"]

        def __init__(self, params: PIVParams):
            super().__init__("Settings")
            self.params = params
            form = QtWidgets.QFormLayout(self)
            self.fmt = QtWidgets.QComboBox()
            self.fmt.addItems(self.FORMATS)
            self.fmt.setCurrentText(params.file_fmt)
            self.wind = QtWidgets.QSpinBox()
            self.wind.setRange(4, 512)
            self.wind.setValue(params.wind_size)
            self.ovl = QtWidgets.QSpinBox()
            self.ovl.setRange(0, 511)
            self.ovl.setValue(params.overlap)
            self.mode = QtWidgets.QComboBox()
            # all three engine pass modes (the reference form offers only
            # CWS/DWS, ControlsWidgets.py:106-114; DEF is this engine's
            # deforming-window mode, models/multipass.py)
            self.mode.addItems(["CWS", "DWS", "DEF"])
            self.mode.setCurrentText(params.multipass_mode)
            self.dev = QtWidgets.QComboBox()
            devices = sorted(DeviceMap.devices())
            self.dev.addItems(devices)
            self.dev.setCurrentText(
                params.device if params.device in devices
                else "cuda" if "cuda" in devices else "cpu")
            self.scale = QtWidgets.QLineEdit(str(params.scale))
            self.dt = QtWidgets.QLineEdit(str(params.dt))
            self.save_opt = QtWidgets.QComboBox()
            self.save_opt.addItems(self.SAVE_OPTS)
            self.save_opt.setCurrentText(params.save_opt or self.SAVE_OPTS[0])
            self.mp = QtWidgets.QSpinBox()
            self.mp.setRange(1, 10)
            self.mp.setValue(params.multipass)
            self.mp_scale = QtWidgets.QLineEdit(str(params.multipass_scale))
            self.save_dir = QtWidgets.QLineEdit(params.save_dir)
            self.regime = QtWidgets.QComboBox()
            self.regime.addItems(["offline", "online"])
            self.regime.setCurrentText(params.regime or "offline")
            self.folder_mode = QtWidgets.QComboBox()
            self.folder_mode.addItems(["pairs", "sequential"])
            self.folder_mode.setCurrentText(params.folder_mode or "pairs")
            # extras beyond the reference form, persisted in the
            # settings.json "extras" key (utils/config.PIVParams.extras)
            ex = params.extras or {}
            self.mask_path = QtWidgets.QLineEdit(str(ex.get("frame_mask",
                                                            "")))
            self.mask_path.setPlaceholderText("none")
            self.preprocess = QtWidgets.QComboBox()
            self.preprocess.addItems(["none", "clahe", "stretch"])
            self.preprocess.setCurrentText(str(ex.get("preprocess", "none")))
            self.correlation = QtWidgets.QComboBox()
            self.correlation.addItems(["scc", "rpc"])
            self.correlation.setCurrentText(str(ex.get("correlation", "scc")))
            self.smooth_cb = QtWidgets.QCheckBox("smoothn (GCV)")
            self.smooth_cb.setChecked(bool(ex.get("smooth", False)))
            self.rescue_cb = QtWidgets.QCheckBox("second-peak rescue")
            self.rescue_cb.setChecked(bool(ex.get("second_peak_fallback",
                                                  False)))
            for label, widget in [
                ("File format", self.fmt), ("Window size [px]", self.wind),
                ("Overlap [px]", self.ovl), ("Multipass mode", self.mode),
                ("Device", self.dev), ("Scale [mm/px]", self.scale),
                ("dt [us]", self.dt), ("Save options", self.save_opt),
                ("Multipass count", self.mp), ("Multipass scale", self.mp_scale),
                ("Save directory", self.save_dir), ("Regime", self.regime),
                ("Folder mode", self.folder_mode),
                ("Mask image", self.mask_path),
                ("Preprocess", self.preprocess),
                ("Correlation", self.correlation),
                ("Smooth fields", self.smooth_cb),
                ("Vector rescue", self.rescue_cb),
            ]:
                form.addRow(label, widget)
            confirm = QtWidgets.QPushButton("Confirm")
            confirm.clicked.connect(self.confirm_changes)
            form.addRow(confirm)

        def confirm_changes(self):
            p = self.params
            p.file_fmt = self.fmt.currentText()
            p.wind_size = self.wind.value()
            p.overlap = self.ovl.value()
            p.multipass_mode = self.mode.currentText()
            p.device = self.dev.currentText()
            p.scale = float(self.scale.text())
            p.dt = float(self.dt.text())
            p.save_opt = self.save_opt.currentText()
            p.multipass = self.mp.value()
            p.multipass_scale = float(self.mp_scale.text())
            p.save_dir = self.save_dir.text()
            p.regime = self.regime.currentText()
            p.folder_mode = self.folder_mode.currentText()
            # beyond-reference form extras persist too (round-5 fix: they
            # were per-run only; reference-style loaders ignore the key)
            p.extras = {
                "frame_mask": self.mask_path.text().strip(),
                "preprocess": self.preprocess.currentText(),
                "correlation": self.correlation.currentText(),
                "smooth": self.smooth_cb.isChecked(),
                "second_peak_fallback": self.rescue_cb.isChecked(),
            }
            p.to_json()

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("torchpiv-tpu")
            self.params = PIVParams.from_json()
            self.thread = None
            self.bridge = None

            central = QtWidgets.QWidget()
            layout = QtWidgets.QHBoxLayout(central)
            self.setCentralWidget(central)

            # left: views
            views = QtWidgets.QVBoxLayout()
            self.field = FieldCanvas()
            self.profile = ProfileCanvas()
            views.addWidget(NavigationToolbar2QT(self.field, self))
            views.addWidget(self.field, stretch=3)
            views.addWidget(self.profile, stretch=1)
            layout.addLayout(views, stretch=3)

            # right: controls
            controls = QtWidgets.QVBoxLayout()
            self.settings = SettingsForm(self.params)
            controls.addWidget(self.settings)

            folder_btn = QtWidgets.QPushButton("Choose folder…")
            folder_btn.clicked.connect(self.choose_folder)
            controls.addWidget(folder_btn)
            self.folder_label = QtWidgets.QLabel(self.params.folder or "(no folder)")
            self.folder_label.setWordWrap(True)
            controls.addWidget(self.folder_label)

            self.start_btn = QtWidgets.QPushButton("Start PIV")
            self.start_btn.clicked.connect(self.toggle_start_stop)
            controls.addWidget(self.start_btn)
            self.pause_btn = QtWidgets.QPushButton("Pause")
            self.pause_btn.setCheckable(True)
            self.pause_btn.toggled.connect(self.toggle_pause)
            controls.addWidget(self.pause_btn)
            self.pbar = QtWidgets.QProgressBar()
            controls.addWidget(self.pbar)

            # view controls (reference ViewSettings, ControlsWidgets.py:312-
            # 372 + PIVwidgets.py:125-251: field selector, profile slider/
            # orientation, streamlines, colorbar min/max scale sliders,
            # grid/axes toggles, movable profile line)
            view_box = QtWidgets.QGroupBox("View")
            vform = QtWidgets.QFormLayout(view_box)
            self.stream_cb = QtWidgets.QCheckBox("Streamlines")
            self.stream_cb.toggled.connect(self._set_stream)
            vform.addRow(self.stream_cb)
            self.vectors_cb = QtWidgets.QCheckBox("Vectors")
            self.vectors_cb.toggled.connect(self._set_vectors)
            vform.addRow(self.vectors_cb)
            self.field_combo = QtWidgets.QComboBox()
            self.field_combo.currentTextChanged.connect(self._set_key)
            vform.addRow("Field", self.field_combo)
            self.prof_slider = QtWidgets.QSlider(QtCore.Qt.Horizontal)
            self.prof_slider.valueChanged.connect(self._set_profile_index)
            vform.addRow("Profile", self.prof_slider)
            self.orient_combo = QtWidgets.QComboBox()
            self.orient_combo.addItems(["Horizontal", "Vertical"])
            self.orient_combo.currentTextChanged.connect(self._set_orientation)
            vform.addRow("Orientation", self.orient_combo)
            self.profile_cb = QtWidgets.QCheckBox("Profile line")
            self.profile_cb.setChecked(True)
            self.profile_cb.toggled.connect(self._set_profile_line)
            vform.addRow(self.profile_cb)
            self.grid_cb = QtWidgets.QCheckBox("Grid")
            self.grid_cb.toggled.connect(self._set_grid)
            vform.addRow(self.grid_cb)
            self.axes_cb = QtWidgets.QCheckBox("Axes")
            self.axes_cb.setChecked(True)
            self.axes_cb.toggled.connect(self._set_axes)
            vform.addRow(self.axes_cb)
            # colorbar scale: auto, or min/max percent of the data range
            self.auto_scale_cb = QtWidgets.QCheckBox("Auto colorbar")
            self.auto_scale_cb.setChecked(True)
            self.auto_scale_cb.toggled.connect(self._update_scale)
            vform.addRow(self.auto_scale_cb)
            self.vmin_slider = QtWidgets.QSlider(QtCore.Qt.Horizontal)
            self.vmin_slider.setRange(0, 100)
            self.vmin_slider.setValue(0)
            self.vmin_slider.valueChanged.connect(self._update_scale)
            vform.addRow("Min %", self.vmin_slider)
            self.vmax_slider = QtWidgets.QSlider(QtCore.Qt.Horizontal)
            self.vmax_slider.setRange(0, 100)
            self.vmax_slider.setValue(100)
            self.vmax_slider.valueChanged.connect(self._update_scale)
            vform.addRow("Max %", self.vmax_slider)
            controls.addWidget(view_box)
            # slider follows the movable profile line (and vice versa)
            self.field.on_profile_moved = self.prof_slider.setValue
            open_btn = QtWidgets.QPushButton("Open saved PIV file…")
            open_btn.clicked.connect(self.open_saved)
            controls.addWidget(open_btn)
            video_btn = QtWidgets.QPushButton("PIV Video File…")
            video_btn.clicked.connect(self.run_video)
            controls.addWidget(video_btn)
            controls.addStretch(1)
            layout.addLayout(controls, stretch=1)

            # 2 s live-refresh timer (reference mainWindow.py:35-38)
            self.timer = QtCore.QTimer(self)
            self.timer.setInterval(2000)
            self.timer.timeout.connect(self.refresh_views)

        # -- view plumbing ---------------------------------------------
        def _set_stream(self, on):
            self.field.streamlines = on
            self.refresh_views()

        def _set_vectors(self, on):
            self.field.vectors = on
            self.refresh_views()

        def _set_key(self, key):
            if key:
                self.field.key = key
                self.profile.key = key
                self.refresh_views()

        def _set_profile_index(self, idx):
            self.field.profile_index = idx
            self.profile.index = idx
            self.refresh_views()

        def _set_orientation(self, text):
            horiz = text == "Horizontal"
            self.field.profile_horizontal = horiz
            self.profile.horizontal = horiz
            self.refresh_views()

        def _set_profile_line(self, on):
            self.field.show_profile_line = on
            self.refresh_views()

        def _set_grid(self, on):
            self.field.show_grid = on
            self.refresh_views()

        def _set_axes(self, on):
            self.field.show_axes = on
            self.refresh_views()

        def _update_scale(self, *_):
            """Colorbar limits from the auto checkbox + min/max percent
            sliders over the current field's data range (reference scale
            sliders, ControlsWidgets.py:312-372)."""
            if self.auto_scale_cb.isChecked():
                self.field.vmin = self.field.vmax = None
            else:
                data = Database().get()
                if not data or self.field.key not in data:
                    return
                f = np.asarray(data[self.field.key])
                lo, hi = float(np.nanmin(f)), float(np.nanmax(f))
                span = hi - lo
                pmin = min(self.vmin_slider.value(),
                           self.vmax_slider.value() - 1)
                self.field.vmin = lo + span * pmin / 100.0
                self.field.vmax = lo + span * self.vmax_slider.value() / 100.0
            self.refresh_views()

        def refresh_views(self):
            data = Database().get()
            if data and self.field_combo.count() == 0:
                # field combo from Database keys, skipping coordinates
                self.field_combo.addItems(list(data.keys())[2:])
                self.field_combo.setCurrentText("Vy[m/s]")
                shape = np.asarray(next(iter(data.values()))).shape
                self.prof_slider.setMaximum(max(shape) - 1)
            self.field.redraw()
            self.profile.redraw()

        # -- run control -------------------------------------------------
        def choose_folder(self):
            folder = QtWidgets.QFileDialog.getExistingDirectory(self, "Frames")
            if folder:
                self.params.folder = folder
                self.folder_label.setText(folder)

        def toggle_start_stop(self):
            # one button serves start and stop, switched on its label
            # (reference mainWindow.py:32-34, ControlsWidgets.py:507-511)
            if self.start_btn.text() == "Start PIV":
                self.start_piv()
            else:
                self.stop_piv()

        # online streams have no natural end; tests set a finite idle
        # timeout so the (synchronous-join) worker terminates
        online_idle_timeout = None

        def _form_extras(self):
            """Settings-form options shared by the offline and online
            paths (engine options, preprocessing, field smoothing)."""
            s = self.settings
            extra = {}
            eopts = {}
            if s.mask_path.text().strip():
                eopts["frame_mask"] = s.mask_path.text().strip()
            if s.correlation.currentText() != "scc":
                eopts["correlation"] = s.correlation.currentText()
            if s.rescue_cb.isChecked():
                eopts["second_peak_fallback"] = True
            if eopts:
                extra["engine_options"] = eopts
            if s.preprocess.currentText() != "none":
                extra["preprocess"] = s.preprocess.currentText()
            if s.smooth_cb.isChecked():
                extra["smooth"] = True
            return extra

        def start_piv(self):
            self.settings.confirm_changes()
            self.params.to_json()
            extra = self._form_extras()
            if (self.params.regime or "offline") == "online":
                # the reference selects OnlineWorker for regime=="online"
                # (mainWindow.py:163-164; its OnlineWorker is a broken
                # stub) — here it runs the working OnlinePIV stream
                self._launch(WorkerBridge(target=self._online_worker(extra)))
                return
            self._launch(WorkerBridge(self.params, **extra))

        def _launch(self, bridge):
            self.thread = QtCore.QThread()
            self.bridge = bridge
            self.bridge.moveToThread(self.thread)
            self.thread.started.connect(self.bridge.run)
            self.bridge.progress.connect(self.pbar.setValue)
            self.bridge.output.connect(self.report_output)
            self.bridge.finished.connect(self.report_finish)
            self.bridge.failed.connect(self.report_failed)
            self.thread.start()
            self.timer.start()
            self.start_btn.setText("Stop PIV")

        def _online_worker(self, extra=None):
            """Worker target streaming OnlinePIV results into the views;
            Stop wires through ``OnlinePIV.stop`` (bridge._stopper).
            ``extra`` carries the settings-form options (``_form_extras``):
            engine_options/preprocess pass straight into OnlinePIV; smooth
            is applied per yielded field, mirroring PIVRunner."""
            from ..pipeline import OnlinePIV
            from ..stats import EnsembleAccumulator

            p = self.params
            idle = self.online_idle_timeout
            extra = dict(extra or {})
            smooth = extra.pop("smooth", False)

            def worker(bridge):
                piv = OnlinePIV(
                    p.folder,
                    device=p.device,
                    file_fmt=p.file_fmt,
                    wind_size=p.wind_size,
                    overlap=p.overlap,
                    multipass=p.multipass,
                    multipass_mode=p.multipass_mode,
                    dt=p.dt,
                    scale=p.scale,
                    multipass_scale=p.multipass_scale,
                    idle_timeout=idle,
                    **extra,
                )
                bridge._stopper = piv.stop
                acc = EnsembleAccumulator()
                x = y = None
                for x, y, u, v in piv():
                    if smooth:
                        from ..stats.smoothing import smooth_vector_field

                        s = None if smooth is True else float(smooth)
                        # statically-masked (ROI) windows stay at zero and
                        # are excluded from the fit; yielded fields are
                        # row-flipped, so flip the mask (same contract as
                        # PIVRunner.run)
                        wm = (piv.engine.window_masked[-1]
                              if piv.engine is not None else None)
                        wm = (np.flip(wm.cpu().numpy(), axis=0)
                              if wm is not None else None)
                        u, v = smooth_vector_field(u, v, mask=wm, s=s,
                                                   robust=True)
                        if wm is not None:
                            u[wm] = 0.0
                            v[wm] = 0.0
                    acc.add(u, v)
                    # unbounded stream: progress shows the pair count mod 100
                    bridge.progress.emit(acc.n % 100)
                    bridge.output.emit(
                        {"x[mm]": x, "y[mm]": y, "Vx[m/s]": u, "Vy[m/s]": v})
                if acc.n:
                    bridge.progress.emit(100)
                    bridge.finished.emit(dict(acc.finalize(x, y)))
                else:
                    bridge.failed.emit()

            return worker

        def stop_piv(self):
            if self.bridge:
                self.bridge.stop()
            self.start_btn.setText("Start PIV")

        def toggle_pause(self, paused):
            if self.bridge and self.bridge.runner is not None:
                self.bridge.runner.pause(paused)

        def report_output(self, output):
            Database().set(output)

        def report_finish(self, table):
            Database().set(table)
            self.timer.stop()
            self.refresh_views()
            self.start_btn.setText("Start PIV")
            if self.thread:
                self.thread.quit()

        def report_failed(self):
            self.timer.stop()
            self.start_btn.setText("Start PIV")
            QtWidgets.QMessageBox.critical(
                self, "PIV failed",
                "No image pairs were processed — check folder and file format.",
            )

        def run_video(self):
            """PIV over a video file's frame stream — the reference's
            'PIV Video File' menu (mainWindow.py:79-86) merely stored the
            filename as the folder; here it actually runs ``VideoPIV``
            with the current settings and streams results into the views.
            """
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "PIV Video File",
                filter="Videos (*.avi *.mp4 *.mov *.mkv);;All files (*)",
            )
            if not path:
                return
            self.settings.confirm_changes()
            from ..pipeline import VideoPIV
            from ..stats import EnsembleAccumulator

            p = self.params

            def worker(bridge):
                piv = VideoPIV(
                    path,
                    device=p.device,
                    wind_size=p.wind_size,
                    overlap=p.overlap,
                    multipass=p.multipass,
                    multipass_mode=p.multipass_mode,
                    dt=p.dt,
                    scale=p.scale,
                    multipass_scale=p.multipass_scale,
                    folder_mode="sequential",
                )
                total = max(len(piv), 1)
                acc = EnsembleAccumulator()
                x = y = None
                for i, (x, y, u, v) in enumerate(piv()):
                    acc.add(u, v)
                    bridge.progress.emit(int((i + 1) / total * 100))
                    bridge.output.emit(
                        {"x[mm]": x, "y[mm]": y, "Vx[m/s]": u, "Vy[m/s]": v})
                if acc.n:
                    bridge.finished.emit(dict(acc.finalize(x, y)))
                else:
                    bridge.failed.emit()

            self._launch(WorkerBridge(target=worker))

        def open_saved(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Saved PIV table", filter="Tables (*.txt *.csv)"
            )
            if path:
                Database().load(path)
                self.field_combo.clear()
                self.refresh_views()


def _install_excepthook():  # pragma: no cover
    """Global excepthook -> critical message box with the traceback
    (reference mainWindow.py:203-256); KeyboardInterrupt passes through."""

    def hook(exc_type, value, tb):
        if issubclass(exc_type, KeyboardInterrupt):
            sys.__excepthook__(exc_type, value, tb)
            return
        text = "".join(traceback.format_exception(exc_type, value, tb))
        print(text, file=sys.stderr)
        if QtWidgets.QApplication.instance() is not None:
            QtWidgets.QMessageBox.critical(None, "Error", text)

    sys.excepthook = hook


def runGUI():  # pragma: no cover
    """Launch the GUI (reference runGUI, mainWindow.py:259-265)."""
    require_qt()
    _install_excepthook()
    app = QtWidgets.QApplication(sys.argv)
    app.setStyle("fusion")
    win = MainWindow()
    win.resize(1200, 800)
    win.show()
    sys.exit(app.exec_())
