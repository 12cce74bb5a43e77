"""System façade: construction, per-frame entry points, mode switches,
reset, shutdown, trajectory export.

JAX rebuild of the reference's System class (reference:
src/System.cc:38-506, include/System.h:62-123). The reference spawns
LocalMapping / LoopClosing / Viewer threads and cross-wires pointers; here
the pipeline is the host-sequenced functional-map design of
pipeline.tracking, so construction just configures the tracker, and
Shutdown has nothing to join. Trajectory export keeps the reference's
relative-pose-chain semantics (System.cc:336-394): each frame stores
Tcr against its reference keyframe, and the saved pose is Tcr * Trw with
the keyframe pose as of save time, so loop-closure / GBA corrections
propagate into saved trajectories.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .geometry import se3
from .pipeline import Tracker, TrackerConfig, TrackState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


_SENSOR_NAME = {Sensor.MONOCULAR: "mono", Sensor.STEREO: "stereo",
                Sensor.RGBD: "rgbd"}


class LazyPose:
    """4x4 Tcw (world->camera) materialized on first access.

    The per-frame Track* entries return this instead of forcing the pose
    off-device: an eager device->host copy makes the host wait for the
    device and would serialize the pipelined tracking step. Acts like an ndarray (`np.asarray(pose)`, `pose[...]`);
    `is None` checks keep working because untracked frames return None.
    """
    __slots__ = ("_R", "_t", "_T")

    def __init__(self, R, t):
        self._R, self._t = R, t
        self._T = None

    def _mat(self) -> np.ndarray:
        if self._T is None:
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = np.asarray(self._R)
            T[:3, 3] = np.asarray(self._t)
            self._T = T
        return self._T

    def matrix(self) -> np.ndarray:
        return self._mat()

    def __array__(self, dtype=None, copy=None):
        m = self._mat()
        return m.astype(dtype) if dtype is not None else m

    def __getitem__(self, key):
        return self._mat()[key]

    @property
    def shape(self):
        return (4, 4)

    def __repr__(self):
        return f"LazyPose({self._mat()!r})" if self._T is not None \
            else "LazyPose(<on device>)"


class System:
    """User-facing façade (reference: System.h:62-123).

    Parameters mirror the reference constructor minus the vocabulary file
    (the packaged offline-trained 88.5k-word tree loads automatically —
    place.vocabulary.load_default_vocabulary, our ORBvoc.txt counterpart;
    reference: System.cc:71) and the viewer flag (visualization.export
    replaces the Pangolin GUI).
    """

    def __init__(self, config: TrackerConfig | None = None,
                 sensor: Sensor = Sensor.RGBD, settings_path: str | None = None,
                 use_viewer: bool = False, viewer_port: int = 8765,
                 expected_frames: int | None = None):
        if config is None and settings_path is not None:
            from .dataio.settings import load_tracker_config
            config = load_tracker_config(settings_path,
                                         expected_frames=expected_frames,
                                         sensor=_SENSOR_NAME[sensor])
        if config is None:
            config = TrackerConfig()
        config.sensor = _SENSOR_NAME[sensor]
        self.sensor = sensor
        self.config = config
        self.tracker = Tracker(config)
        self._localization_mode = False
        self._shutdown = False
        self._big_change_idx = 0
        # live web viewer (reference: Viewer thread, System.cc:105-108)
        self.viewer = None
        if use_viewer:
            from .visualization.viewer import Viewer
            self.viewer = Viewer(self, port=viewer_port)

    # -- per-frame entries (reference: System.cc:123-313) ----------------
    def track_monocular(self, img, timestamp: float = 0.0):
        """Reference: System::TrackMonocular (System.cc:224-282).
        Returns 4x4 Tcw (world->camera) or None when tracking failed."""
        assert self.sensor == Sensor.MONOCULAR, "wrong sensor for TrackMonocular"
        self.tracker._timestamp = timestamp
        if self.viewer is not None:
            self.viewer.push_frame(img)
        out = self.tracker.process_mono(img)
        return self._pose44(out)

    def track_stereo(self, img_left, img_right, timestamp: float = 0.0):
        """Reference: System::TrackStereo (System.cc:123-180)."""
        assert self.sensor == Sensor.STEREO, "wrong sensor for TrackStereo"
        self.tracker._timestamp = timestamp
        if self.viewer is not None:
            self.viewer.push_frame(img_left)
        out = self.tracker.process_stereo(img_left, img_right)
        return self._pose44(out)

    def track_rgbd(self, img, depth, timestamp: float = 0.0):
        """Reference: System::TrackRGBD (System.cc:182-222)."""
        assert self.sensor == Sensor.RGBD, "wrong sensor for TrackRGBD"
        self.tracker._timestamp = timestamp
        if self.viewer is not None:
            self.viewer.push_frame(img)
        out = self.tracker.process_rgbd(img, depth)
        return self._pose44(out)

    @staticmethod
    def _pose44(out):
        if out is None:
            return None
        return LazyPose(out[0], out[1])

    # -- mode switches (reference: System.cc:284-307) --------------------
    def activate_localization_mode(self):
        """Tracking-only: the map is frozen, no keyframes are inserted
        (reference: System::ActivateLocalizationMode System.cc:284)."""
        self._localization_mode = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self._localization_mode = False
        self.tracker.localization_only = False

    def map_changed(self) -> bool:
        """Poll-style big-map-change signal (reference: System::MapChanged
        System.cc:309-320, Map::GetLastBigChangeIdx)."""
        idx = self.tracker.n_kf_host
        if self.tracker.loop_closer is not None:
            idx += 1000 * self.tracker.loop_closer.n_loops_closed
        changed = idx != self._big_change_idx
        self._big_change_idx = idx
        return changed

    def reset(self):
        """Clear the map and restart tracking (reference: System::Reset ->
        Tracking::Reset, Tracking.cc:1780-1826)."""
        self.tracker = Tracker(self.config)

    def shutdown(self):
        """Reference: System::Shutdown (System.cc:315-334) joins the three
        threads; the functional pipeline has nothing to join — only the
        in-flight pipelined frame must be finalized."""
        self.tracker.flush()
        if self.viewer is not None:
            self.viewer.close()
        self._shutdown = True

    # -- state inspection (reference: System.h:137-146) ------------------
    def get_tracking_state(self) -> TrackState:
        return self.tracker.state

    def get_tracked_map_points(self) -> int:
        return self.tracker._n_inliers

    # -- trajectory export (reference: System.cc:336-486) ----------------
    def _chain_poses(self, keyframes_only: bool = False):
        """Resolve the relative-pose chain to absolute Tcw per frame.

        rel_log references keyframes by stable uid (slots are recycled by
        map compaction): a uid still living in a slot uses the CURRENT map
        pose — loop-closure / GBA corrections propagate into saved
        trajectories exactly like the reference's Trw chains — while a uid
        evicted by compaction uses its archived pose (the reference walks
        the spanning tree to the first non-bad parent, System.cc:376-382;
        culled keyframes here are >=90% redundant so their final pose is
        already consistent with the survivors)."""
        tr = self.tracker
        tr.flush()
        m = tr.map
        kf_R = np.asarray(m.kf_R)
        kf_t = np.asarray(m.kf_t)
        rows = []
        if keyframes_only:
            n = tr.n_kf_host
            frame_ids = np.asarray(m.kf_frame_id[:n])
            ts_by_frame = {fid: ts for fid, ts, *_ in tr.rel_log}
            for k in range(n):
                ts = ts_by_frame.get(int(frame_ids[k]), float(frame_ids[k]))
                rows.append((ts, kf_R[k], kf_t[k]))
            return rows
        slot_of_uid = {uid: slot for slot, uid in enumerate(tr.kf_uids)}

        def resolve(uid, depth=0):
            """uid -> current world pose: live slot directly, archived
            entries through their rel-to-anchor chain (the reference's
            spanning-tree walk to a live parent, System.cc:376-382) — so
            corrections applied after a compaction still propagate."""
            slot = slot_of_uid.get(uid)
            if slot is not None:
                return kf_R[slot], kf_t[slot]
            entry = tr.kf_archive.get(uid)
            if entry is None or depth > len(tr.kf_archive):
                return None
            anchor_uid, R_rel, t_rel = entry
            if anchor_uid < 0:  # absolute (legacy checkpoint)
                return R_rel, t_rel
            base = resolve(anchor_uid, depth + 1)
            if base is None:
                return None
            Ra, ta = base
            return R_rel @ Ra, R_rel @ ta + t_rel

        for frame_id, ts, ref_uid, Rcr, tcr in tr.rel_log:
            Rcr = np.asarray(Rcr)
            tcr = np.asarray(tcr)
            base = resolve(ref_uid)
            if base is None:  # pre-compaction log, never archived: skip
                continue
            Rr, tr_ = base
            Rcw = Rcr @ Rr
            tcw = Rcr @ tr_ + tcr
            rows.append((ts, Rcw, tcw))
        return rows

    @staticmethod
    def _tum_line(ts, Rcw, tcw):
        # output camera-to-world (reference: System.cc:372-392)
        Rwc = Rcw.T
        twc = -Rwc @ tcw
        import jax.numpy as jnp
        q = np.asarray(se3.matrix_to_quat(jnp.asarray(Rwc)))  # [w, x, y, z]
        return (f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")

    def save_trajectory_tum(self, path: str):
        """Per-frame camera trajectory, TUM format `ts tx ty tz qx qy qz qw`
        (reference: System::SaveTrajectoryTUM System.cc:336-394)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses():
                f.write(self._tum_line(ts, Rcw, tcw) + "\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe poses only (reference: System::SaveKeyFrameTrajectoryTUM
        System.cc:396-431)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses(keyframes_only=True):
                f.write(self._tum_line(ts, Rcw, tcw) + "\n")

    def save_trajectory_kitti(self, path: str):
        """Per-frame camera-to-world 3x4 row-major (reference:
        System::SaveTrajectoryKITTI System.cc:433-486)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses():
                Rwc = Rcw.T
                twc = -Rwc @ tcw
                vals = [Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                        Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                        Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2]]
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")
