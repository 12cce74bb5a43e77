"""Host-side tracking state machine (the Tracking front end).

JAX rebuild of the reference's Tracking thread (reference:
src/Tracking.cc Track() state machine, :287-581): the decision logic
(init / motion-model / reference-KF fallback / local-map / keyframe need /
lost) runs in Python on a handful of scalar readbacks per frame, while all
array work happens in the jitted steps of pipeline.steps. Local mapping
(culling + local BA) runs synchronously after each keyframe insertion —
bounded-iteration chunks replacing the mapping thread + mbAbortBA protocol
(SURVEY.md §2.5 P1/P6).

Thresholds follow SURVEY.md §2.6 "Tracking decisions".
"""
from __future__ import annotations

import concurrent.futures
import enum
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..frontend import OrbExtractor
from ..geometry import se3
from ..mapstate.map import MapConfig, MapState, empty_map
from ..matching.search import FeatureSet
from ..optim.residuals import CamParams
from . import steps


@jax.jit
def _rel_to_kf(R, t, kf_R, kf_t, ref_kf):
    """Tcr = Tcw * Twr(ref) as one dispatch (trajectory relative chain)."""
    return se3.compose(R, t, *se3.inverse(kf_R[ref_kf], kf_t[ref_kf]))


@jax.jit
def _stack_stats(*stats):
    """Stack K per-frame stats vectors into one [K,6] readback payload."""
    return jnp.stack(stats)


@jax.jit
def _map_counters(m: MapState) -> jax.Array:
    """[4] int32: [n_kf slots used, live keyframes, n_lm slots used,
    live landmarks] — ONE small transfer drives the host's map-lifecycle
    decisions (compaction / growth)."""
    return jnp.stack([
        m.n_kf, jnp.sum(m.kf_valid.astype(jnp.int32)),
        m.n_lm, jnp.sum(m.lm_valid.astype(jnp.int32))])


@jax.jit
def _remap_ids(ids, inv, old_valid):
    """Remap an id array through an old->new permutation, dropping ids
    that were invalid pre-compaction (feature->landmark lists held by the
    host across a compact_landmarks pass)."""
    safe = jnp.clip(ids, 0)
    ok = (ids >= 0) & old_valid[safe]
    return jnp.where(ok, inv[safe], -1)


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


_VOC_CACHE: dict = {}


def default_vocabulary():
    """The packaged offline-trained vocabulary, loaded once per process
    (reference: System loads ORBvoc.txt at construction, System.cc:71 —
    the ~10-20 s parse there is a ~100 ms npz load here). numpy-backed so
    jitted users embed the tree as trace constants."""
    if "voc" not in _VOC_CACHE:
        from ..place.vocabulary import load_default_vocabulary
        _VOC_CACHE["voc"] = load_default_vocabulary(as_numpy=True)
    return _VOC_CACHE["voc"]


@dataclass
class TrackerConfig:
    sensor: str = "rgbd"  # "mono" | "stereo" | "rgbd"
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    width: int = 640
    height: int = 480
    n_features: int = 1000
    th_depth: float = 40.0  # in baseline units (yaml ThDepth); meters = th_depth * bf/fx
    fps: float = 30.0
    min_init_features: int = 500
    # monocular bootstrap gates (reference: >=100 matches and >=100 tracked
    # after BA, Tracking.cc:687,787-799). Configurable because the gate
    # scales with detector density: synthetic scenes carry ~200 level-0
    # corners vs >400 on real imagery with the reference's 2x init extractor.
    min_init_matches: int = 100
    map_cfg: MapConfig = field(default_factory=MapConfig)
    # local BA every keyframe (bounded-iteration chunk)
    local_ba_iters: int = 5
    # Descriptor acceptance thresholds for projection searches (reference
    # TH_HIGH=100). Knobs exist because the right value is a property of
    # the image source's descriptor statistics: with duplicate-landmark
    # merging in place the reference value measures best on the synthetic
    # suite as well (tighter gates amputate legitimate long-baseline
    # re-matches and destabilize tracking).
    desc_th: int = 100
    desc_th_local: int = 100
    # raw-depth -> meters multiplier applied ON DEVICE (reference:
    # DepthMapFactor, Tracking.cc:144-148 convertTo(CV_32F, factor)).
    # Feeding raw uint16 depth + factor instead of host-converted float32
    # halves the host->device depth upload.
    depth_factor: float = 1.0
    # radial-tangential distortion (k1, k2, p1, p2, k3) applied to keypoint
    # coordinates once per frame right after extraction (reference:
    # Frame::UndistortKeyPoints, Frame.cc:434-469; params from the YAML's
    # Camera.k1..k3, Tracking.cc:53-148). Zeros = rectified input (stereo
    # pipelines feed rectified pairs, like the reference).
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # map lifecycle: when the SoA capacities run low the tracker compacts
    # dead slots and, if still tight, doubles the capacity (grow_map) —
    # the fixed-shape equivalent of the reference's unbounded map
    # (Map.cc:32-44). Each growth recompiles the pipeline once for the new
    # shapes; O(log K) recompiles over a sequence of any length.
    allow_map_growth: bool = True

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)

    @property
    def cam(self) -> CamParams:
        return CamParams(*[jnp.float32(v) for v in
                           (self.fx, self.fy, self.cx, self.cy, self.bf)])

    @property
    def depth_threshold(self) -> float:
        """ThDepth * baseline in meters (reference: Tracking.cc:137)."""
        return self.th_depth * self.bf / self.fx


class Tracker:
    """Monocular/stereo/RGB-D tracker over a versioned functional map."""

    def __init__(self, cfg: TrackerConfig):
        if cfg.map_cfg.n_feat != cfg.n_features:
            raise ValueError(
                f"map_cfg.n_feat ({cfg.map_cfg.n_feat}) must equal "
                f"n_features ({cfg.n_features}): keyframe SoA rows are "
                "fixed-width feature arrays")
        self.cfg = cfg
        self.extractor = OrbExtractor(n_features=cfg.n_features)
        self.map: MapState = empty_map(cfg.map_cfg)
        # keypoint undistortion model (None when input is rectified)
        self._undist_cam = None
        if cfg.has_distortion:
            from ..models.camera import PinholeCamera
            self._undist_cam = PinholeCamera.create(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, jnp.asarray(cfg.dist),
                cfg.width, cfg.height)
        self.state = TrackState.NOT_INITIALIZED
        self.last_obs: steps.FrameObs | None = None
        self.last_R = jnp.eye(3)
        self.last_t = jnp.zeros(3)
        self.velocity = None  # (R_rel, t_rel): T_cur<-last
        self.ref_kf = 0
        self.last_kf_frame = -1
        self.frame_count = 0
        self.trajectory: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.n_kf_host = 0
        self._n_inliers = 0
        # keyframe identity across slot recycling: kf_uids[slot] is the
        # stable uid of the keyframe living in that slot (uid = insertion
        # order); rel_log keys trajectory reference keyframes by uid, and
        # compaction archives evicted keyframes under their uid.
        # Archive entries are RELATIVE to a live anchor keyframe:
        # uid -> (anchor_uid, R_rel, t_rel) with T_evicted = rel o T_anchor
        # at archive time, so loop-closure / GBA corrections applied to the
        # live map AFTER a compaction still propagate into trajectories
        # resolved through archived keyframes (the reference instead walks
        # the spanning tree to a live parent, System.cc:376-382). An
        # anchor_uid of -1 marks an absolute entry (legacy checkpoints).
        self.kf_uids: list[int] = []
        self.kf_archive: dict[int, tuple[int, np.ndarray, np.ndarray]] = {}
        self._kf_uid_counter = 0
        self._maintenance_due = False
        self._counter_fut = None
        # post-relocalization gates (reference: mnLastRelocFrameId —
        # 1s keyframe embargo Tracking.cc:1150-1160, widened local search
        # :1393-1399, raised inlier bar :1119-1126)
        self.last_reloc_frame = -(10 ** 9)
        self._step = steps.build_track_frame_step(
            self.extractor, cfg.width, cfg.height, self._undist_cam)
        # place recognition: vocabulary is trained from the first keyframe's
        # descriptors (domain-matched; the reference ships a pre-trained
        # ORBvoc.txt absent from this environment — SURVEY §7.7)
        self.db = None
        self.loop_closer = None
        # monocular two-view bootstrap state (reference:
        # MonocularInitialization, Tracking.cc:638-726)
        self._init_obs: steps.FrameObs | None = None
        self._init_frame_id = -1
        # localization-only mode: track against the frozen map, never
        # insert keyframes (reference: System::ActivateLocalizationMode ->
        # mbOnlyTracking, Tracking.cc:222-235)
        self.localization_only = False
        # relative-pose log for trajectory export (reference:
        # mlRelativeFramePoses/mlpReferences, Tracking.cc:562-579): storing
        # Tcr lets saved trajectories ride along with post-hoc keyframe
        # corrections (loop closure / GBA), System.cc:336-394 semantics.
        self.rel_log: list[tuple[int, float, int, object, object]] = []
        self._timestamp = 0.0
        # pipelined tracking: in-flight frames whose stats readbacks happen
        # on a background reader thread. Stats of fetch_batch consecutive
        # frames are stacked ON DEVICE into one [K,6] array and fetched in a
        # SINGLE transfer: the device->host round trip is paid once per K
        # frames instead of once per frame, which otherwise caps the whole
        # pipeline at 1/RTT frames/s.
        # A frame finalizes as soon as its batch has landed; pipeline_depth
        # bounds the backlog so decisions can't lag unboundedly (the same
        # bounded lag the reference's LocalMapping queue gives keyframe
        # decisions, Tracking.cc:1233).
        self._pending: list = []
        self._open: list = []  # pending entries not yet assigned a fetch
        self.pipeline_depth = 8
        self.fetch_batch = 4
        self._reader = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="stats-reader")
        # deferred loop-closure detection handle (LoopCloser.begin/finish)
        self._pending_loop = None

    # -- helpers ---------------------------------------------------------
    def _frame_obs(self, img, depth_map):
        feats = self.extractor(jnp.asarray(img))
        xy = feats.xy
        if depth_map is not None:
            dm = jnp.asarray(depth_map).astype(jnp.float32)
            if self.cfg.depth_factor != 1.0:
                dm = dm * jnp.float32(self.cfg.depth_factor)
            yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, self.cfg.height - 1)
            xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, self.cfg.width - 1)
            d = dm[yi, xi]
            # Depth-edge gate: corners on occlusion boundaries flip between
            # foreground and background depth with sub-pixel motion, which
            # poisons landmarks (classic RGB-D edge noise). Reject features
            # whose 3x3 depth neighborhood is inconsistent (>4% spread or
            # any invalid return).
            H, W = self.cfg.height, self.cfg.width
            dmin = d
            dmax = d
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    dn = dm[jnp.clip(yi + dy, 0, H - 1), jnp.clip(xi + dx, 0, W - 1)]
                    dmin = jnp.minimum(dmin, dn)
                    dmax = jnp.maximum(dmax, dn)
            edge = (dmin <= 0) | ((dmax - dmin) > 0.04 * jnp.clip(d, 1e-6, None))
            d = jnp.where((d > 0) & ~edge, d, -1.0)
        else:
            d = jnp.full(xy.shape[0], -1.0)
        # undistort AFTER depth sampling (the depth map is aligned with the
        # raw image) and BEFORE mvuRight synthesis (the reference computes
        # mvuRight from undistorted keypoints, Frame.cc:687-698)
        if self._undist_cam is not None:
            xy = self._undist_cam.undistort_points(xy)
        ur = steps.make_feature_uvr(xy[:, 0], d, self.cfg.cam.bf)
        fs = FeatureSet(xy, ur, feats.octave, feats.angle, feats.desc, feats.valid)
        return steps.FrameObs(fs, d, jnp.full(xy.shape[0], -1, jnp.int32))

    def _frame_obs_stereo(self, img_left, img_right):
        """Stereo frame: joint L/R extraction + row-band depth association
        (reference: Frame stereo ctor Frame.cc:61-117 + ComputeStereoMatches
        Frame.cc:501-675)."""
        feats, sd = self.extractor.stereo(
            jnp.asarray(img_left), jnp.asarray(img_right),
            self.cfg.bf, self.cfg.fx)
        fs = FeatureSet(feats.xy, sd.u_right, feats.octave, feats.angle,
                        feats.desc, feats.valid)
        return steps.FrameObs(fs, sd.depth,
                              jnp.full(feats.xy.shape[0], -1, jnp.int32))

    def _log_pose(self, frame_id, R, t, ref_kf=None, Rcr=None, tcr=None,
                  ts=None):
        # keep device arrays: forcing them to numpy here waits for the
        # device twice per frame; conversion happens in trajectory_arrays()
        self.trajectory.append((frame_id, R, t))
        # relative chain: Tcr = Tcw * Twr with the ref KF's pose AS OF NOW —
        # later keyframe corrections then propagate into saved trajectories.
        # The fused RGB-D step computes Tcr in-device (res.Rcr/tcr); other
        # paths derive it here in ONE jitted dispatch.
        if ref_kf is None:
            ref_kf = self.ref_kf
        if Rcr is None:
            Rcr, tcr = _rel_to_kf(R, t, self.map.kf_R, self.map.kf_t,
                                  jnp.int32(ref_kf))
        # log the STABLE uid, not the slot: keyframe compaction recycles
        # slots, and trajectory export resolves uid -> live slot or the
        # archived pose (reference: mlpReferences holds KeyFrame pointers
        # which survive erasure as "bad" husks, Tracking.cc:562-579)
        ref_uid = self.kf_uids[ref_kf] if ref_kf < len(self.kf_uids) else 0
        if ts is None:
            ts = self._timestamp
        self.rel_log.append((frame_id, ts, ref_uid, Rcr, tcr))

    # -- main entry ------------------------------------------------------
    def process_rgbd(self, img, depth_map, frame_id=None):
        """Track one RGB-D frame; returns (R, t) world->camera or None.

        Steady-state tracking is ONE fused device call with the stats
        readback DEFERRED by one frame (software pipelining): the
        device->host round trip overlaps the next frame's device compute
        instead of serializing with it. The lost/keyframe decision for frame k is therefore taken
        while frame k+1 runs — the same one-frame lag the reference's
        asynchronous LocalMapping thread has (keyframes take effect only
        when the mapping thread drains its queue, LocalMapping.cc:47-128).
        """
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()

        if self.state == TrackState.NOT_INITIALIZED:
            obs = self._frame_obs(img, depth_map)
            ok = self._initialize(obs, frame_id)
            return (self.last_R, self.last_t) if ok else None

        if self.state == TrackState.LOST:
            obs = self._frame_obs(img, depth_map)
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None

        cfg = self.cfg
        if self._pending:
            # chain device-side on the newest in-flight frame; its step
            # already computed its own velocity (T_p * T_{p-1}^-1) in-device
            p = self._pending[-1][0]
            prev_obs = steps.FrameObs(p.feats, p.depth, p.lm)
            prev_R, prev_t = p.R, p.t
            vel_R, vel_t = p.vel_R, p.vel_t
            have_vel = True
        else:
            prev_obs = self.last_obs
            prev_R, prev_t = self.last_R, self.last_t
            have_vel = self.velocity is not None
            vel_R, vel_t = (self.velocity if have_vel
                            else (jnp.eye(3), jnp.zeros(3)))
        min_obs = 2 if self.n_kf_host > 2 else 1
        th_local = (5.0 if frame_id < self.last_reloc_frame + 2 else 3.0)
        res = self._step(
            cfg.cam, self.map, prev_obs, prev_R, prev_t,
            vel_R, vel_t, have_vel, jnp.int32(self.ref_kf),
            jnp.asarray(img), jnp.asarray(depth_map),
            jnp.float32(cfg.depth_factor),
            jnp.float32(cfg.depth_threshold), jnp.int32(cfg.desc_th),
            jnp.int32(cfg.desc_th_local), jnp.int32(min_obs),
            jnp.float32(th_local))
        self.map = res.map
        # capture the FRAME's timestamp now: _finalize runs several frames
        # later (batched stats readback) when self._timestamp already holds
        # a newer frame's value — logging it there stamped whole fetch
        # batches with one duplicated ts in saved trajectories.
        entry = [res, frame_id, None, self.ref_kf, -1, self._timestamp]
        self._pending.append(entry)
        self._open.append(entry)
        if len(self._open) >= self.fetch_batch:
            self._submit_fetch()
        # finalize every frame whose stats batch has landed; only force a
        # block when the backlog exceeds pipeline_depth (keeps the device
        # busy while decisions lag, like the reference's asynchronous
        # LocalMapping thread lags Tracking)
        while self._pending and (
                (self._pending[0][2] is not None and self._pending[0][2].done())
                or len(self._pending) > self.pipeline_depth):
            if self._pending[0][2] is None:
                self._submit_fetch()
            oldest = self._pending.pop(0)
            if not self._finalize(*oldest):
                # That frame was LOST; every newer in-flight step chained on
                # its bad pose — discard them (the reference likewise drops
                # frames until relocalization succeeds, Tracking.cc:528).
                self._pending.clear()
                self._open.clear()
                return None
        return res.R, res.t

    def _submit_fetch(self):
        """Stack the open frames' stats on device and start ONE
        device->host transfer covering all of them."""
        if not self._open:
            return
        batch, self._open = self._open, []
        z = _stack_stats(*[e[0].stats for e in batch])
        try:
            z.copy_to_host_async()
        except Exception:
            pass  # backends without async host copies: the reader blocks
        fut = self._reader.submit(np.asarray, z)
        for row, e in enumerate(batch):
            e[2] = fut
            e[4] = row

    def _finalize(self, res, frame_id, fut=None, ref_kf=None,
                  row=None, ts=None) -> bool:
        """Deferred per-frame epilogue: read the stats vector (the only
        device->host sync), run the lost/keyframe state machine for the
        frame, and update host tracking state. Returns False when the
        frame turned out LOST (its successor must be discarded)."""
        self._finish_pending_loop()
        if fut is not None:
            stats = fut.result()
            if row is not None and row >= 0:
                stats = stats[row]
        else:
            stats = np.asarray(res.stats)
        mm_in, used_mm, track1_in, local_in, ref_matches, close_pack = (
            int(x) for x in stats)
        # raised local-map bar within 1s of relocalization (reference:
        # Tracking.cc:1119-1126)
        min_local = (50 if frame_id < self.last_reloc_frame + self.cfg.fps
                     else 30)
        if track1_in < 10 or local_in < min_local:
            if self._lost_transition():
                return False  # lost-early reset: map wiped, re-init next
            if self.db is not None:
                obs = steps.FrameObs(res.feats, res.depth, res.lm)
                self._relocalize(obs, frame_id)
            return False
        self.state = TrackState.OK
        R, t = res.R, res.t
        self._n_inliers = local_in
        obs = steps.FrameObs(res.feats, res.depth, res.lm)
        # velocity and the ref-relative trajectory pose were computed in the
        # fused step — the epilogue issues no device work at all
        self.velocity = (res.vel_R, res.vel_t)
        self.last_R, self.last_t = R, t
        self.last_obs = obs
        self._log_pose(frame_id, R, t, ref_kf=ref_kf, Rcr=res.Rcr,
                       tcr=res.tcr, ts=ts)

        tracked_close, non_tracked_close = close_pack // 10000, close_pack % 10000
        if (not self.localization_only
                and self._need_new_keyframe_stats(
                    local_in, ref_matches, tracked_close, non_tracked_close,
                    frame_id)):
            self._create_keyframe(obs, R, t, frame_id)
        return True

    def reset(self):
        """Tracking::Reset (reference: Tracking.cc:1780-1826): clear the
        map, the place-recognition database and all per-run state; the
        next frame re-initializes. Compiled step programs are reused (the
        map shapes don't change)."""
        self.map = empty_map(self.cfg.map_cfg)
        self.state = TrackState.NOT_INITIALIZED
        self.last_obs = None
        self.velocity = None
        self.ref_kf = 0
        self.last_kf_frame = -1
        self.n_kf_host = 0
        self._n_inliers = 0
        self.kf_uids = []
        self.kf_archive = {}
        self._kf_uid_counter = 0
        self.db = None
        self.loop_closer = None
        self._init_obs = None
        self._init_frame_id = -1
        self._pending.clear()
        self._open.clear()
        self._pending_loop = None
        self._counter_fut = None
        self._maintenance_due = False
        self.trajectory.clear()
        self.rel_log.clear()

    def _lost_transition(self) -> bool:
        """Entering LOST: reset outright when the map is immature
        (reference: Tracking.cc:542-551 — lost with <=5 keyframes means
        the map was never good). Returns True if a reset happened."""
        if self.n_kf_host <= 5:
            self.reset()
            return True
        self.state = TrackState.LOST
        self.velocity = None
        return False

    def _finish_pending_loop(self):
        """Complete a deferred loop-closure detection (if any)."""
        if self._pending_loop is not None:
            handle, self._pending_loop = self._pending_loop, None
            corrected = self.loop_closer.finish(self.map, handle)
            if corrected is not None:
                self.map = corrected

    def _poll_gba(self):
        """Advance a pending chunked global BA by one bounded chunk
        (reference: the asynchronous GBA thread, LoopClosing.cc:790-901;
        SURVEY §2.5 P3 — interruption = don't launch the next chunk)."""
        if self.loop_closer is not None and self.loop_closer.gba_running():
            out = self.loop_closer.poll_gba(self.map)
            if out is not None:
                self.map = out

    def flush(self):
        """Finalize the in-flight frames (pipelined RGB-D tracking defers
        decisions by pipeline_depth frames) and any deferred loop
        detection. Call before reading trajectories, state, or the map at
        a sequence boundary."""
        self._submit_fetch()
        while self._pending:
            oldest = self._pending.pop(0)
            if not self._finalize(*oldest):
                self._pending.clear()
                self._open.clear()
        self._finish_pending_loop()
        # a sequence boundary drains any pending chunked global BA too
        while self.loop_closer is not None and self.loop_closer.gba_running():
            self._poll_gba()

    # -- map lifecycle (slot recycling + capacity growth) ------------------
    # The reference's map grows without bound (Map.cc:32-44; NeedNewKeyFrame
    # has no capacity clause, Tracking.cc:1140-1244). The SoA map is
    # fixed-capacity, so the host runs a maintenance pass when slots run
    # low: compact dead keyframe/landmark slots (culling only clears masks)
    # and, if the live set itself approaches capacity, double it (grow_map).
    # Maintenance runs BETWEEN frames with the pipeline drained — in-flight
    # frames hold feature->landmark id arrays that a compaction would
    # silently invalidate.

    @property
    def _kf_margin(self) -> int:
        # keyframes that may still be created while the trigger is in
        # flight: one per finalized pending frame, plus slack
        return self.pipeline_depth + 2

    @property
    def _lm_margin(self) -> int:
        # worst case one keyframe-step's worth of new landmarks per pending
        # frame that turns into a keyframe (~1 per 3 frames, c1b spacing)
        return (self.pipeline_depth // 3 + 2) * self.cfg.n_features

    def _check_maintenance(self):
        """Called at every process_* entry: evaluate the async counter
        fetch and run the (rare) maintenance pass when due."""
        self._poll_gba()
        if self._counter_fut is not None and self._counter_fut.done():
            n_kf, live_kf, n_lm, live_lm = (
                int(x) for x in self._counter_fut.result())
            self._counter_fut = None
            L = self.map.lm_pw.shape[0]
            if n_lm > L - self._lm_margin:
                self._maintenance_due = True
        K = self.map.kf_R.shape[0]
        if self.n_kf_host >= K - self._kf_margin:
            self._maintenance_due = True
        if self._maintenance_due:
            self.flush()
            self._run_maintenance()
            self._maintenance_due = False

    def _run_maintenance(self):
        from ..mapstate.map import (compact_keyframes, compact_landmarks,
                                    grow_map, landmark_compaction_order)
        m = self.map
        K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
        n_kf, live_kf, n_lm, live_lm = (
            int(x) for x in np.asarray(_map_counters(m)))
        grow_k = grow_l = None
        # landmarks: compact when there are enough dead slots to matter
        if n_lm > L - self._lm_margin:
            if n_lm - live_lm >= min(L // 8, self._lm_margin):
                old_valid = m.lm_valid
                order = landmark_compaction_order(old_valid)
                inv = jnp.zeros(L, jnp.int32).at[order].set(
                    jnp.arange(L, dtype=jnp.int32))
                m = compact_landmarks(m)
                if self.last_obs is not None:
                    self.last_obs = self.last_obs._replace(
                        lm=_remap_ids(self.last_obs.lm, inv, old_valid))
                n_lm = live_lm
            if n_lm > L - self._lm_margin:
                grow_l = 2 * L
        # keyframes: compact culled slots; grow when the live set is large
        if self.n_kf_host >= K - self._kf_margin:
            if n_kf - live_kf > 0:
                m = self._compact_keyframes_host(m)
            if self.n_kf_host >= K - self._kf_margin:
                grow_k = 2 * K
        if grow_k or grow_l:
            if self.cfg.allow_map_growth:
                m = grow_map(m, k_max=grow_k or K, l_max=grow_l or L)
                if grow_k and self.db is not None:
                    self.db.grow(grow_k)
            # growth disabled: keyframe insertion refuses at capacity (the
            # round-1 behavior, kept for fixed-budget benchmarking)
        self.map = m

    def _compact_keyframes_host(self, m: MapState) -> MapState:
        """compact_keyframes + the host mirror of its permutation:
        archive evicted poses by uid, repack kf_uids, remap ref_kf, permute
        BoW database rows, remap loop-closer slot state."""
        from ..mapstate.map import compact_keyframes
        valid = np.asarray(m.kf_valid)
        n_live = int(valid.sum())
        # archive evicted keyframes RELATIVE to a live anchor (the nearest
        # live keyframe by slot order — the temporal-chain counterpart of
        # the reference's spanning-tree walk, System.cc:376-382): storing
        # T_evicted o T_anchor^-1 keeps archived trajectory references
        # consistent when a later loop closure / GBA moves the live map.
        kf_R = np.asarray(m.kf_R)
        kf_t = np.asarray(m.kf_t)
        live_slots = np.where(valid)[0]
        for slot, uid in enumerate(self.kf_uids):
            if valid[slot]:
                continue
            if len(live_slots) == 0:
                self.kf_archive[uid] = (-1, kf_R[slot].copy(),
                                        kf_t[slot].copy())
                continue
            anchor = int(live_slots[np.argmin(np.abs(live_slots - slot))])
            Ra, ta = kf_R[anchor], kf_t[anchor]
            R_rel = kf_R[slot] @ Ra.T
            t_rel = kf_t[slot] - R_rel @ ta
            self.kf_archive[uid] = (self.kf_uids[anchor], R_rel, t_rel)
        # old->new slot map (stable: live keyframes keep temporal order)
        rank = np.cumsum(valid) - valid
        old_uids = self.kf_uids
        self.kf_uids = [u for s, u in enumerate(old_uids) if valid[s]]
        if valid[self.ref_kf]:
            self.ref_kf = int(rank[self.ref_kf])
        else:
            self.ref_kf = min(int(rank[self.ref_kf]), max(n_live - 1, 0))
        self.n_kf_host = n_live
        if self.db is not None:
            self.db.permute(np.where(valid)[0], n_live)
        if self.loop_closer is not None:
            self.loop_closer.remap_slots(rank, valid)
        return compact_keyframes(m)

    def process_mono(self, img, frame_id=None):
        """Track one monocular frame; returns (R, t) or None (reference:
        System::TrackMonocular System.cc:224 -> GrabImageMonocular
        Tracking.cc:239). Scale is the monocular gauge: median scene depth
        of the initial map is normalized to 1."""
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()
        obs = self._frame_obs(img, None)
        if self.state == TrackState.NOT_INITIALIZED:
            ok = self._initialize_mono(obs, frame_id)
            return (self.last_R, self.last_t) if ok else None
        return self._process_obs(obs, frame_id)

    def _initialize_mono(self, obs: steps.FrameObs, frame_id) -> bool:
        """Two-view bootstrap (reference: MonocularInitialization
        Tracking.cc:638-726 + CreateInitialMapMonocular :733-843): window
        matching vs the init reference frame, batched H/F RANSAC, initial
        two-keyframe map, full BA, median-depth gauge normalization."""
        from ..matching import search as ms
        from ..solvers import initializer as init_solver
        n_valid = int(jnp.sum(obs.feats.valid))
        if self._init_obs is None:
            if n_valid > 100:  # reference :644
                self._init_obs = obs
                self._init_frame_id = frame_id
            return False
        if n_valid <= 100:
            self._init_obs = None
            return False
        ref = self._init_obs
        idx, dist, matched = ms.search_for_initialization(
            ref.feats, obs.feats, ref.feats.xy)
        n_match = int(jnp.sum(matched))
        if n_match < self.cfg.min_init_matches:  # reference :687
            self._init_obs = None
            return False
        K = (self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy)
        key = jax.random.PRNGKey(0)  # seeded like DUtils SeedRandOnce(0)
        p2 = obs.feats.xy[jnp.clip(idx, 0)]
        res = init_solver.initialize(key, K, ref.feats.xy, p2, matched)
        if not bool(res.success):
            return False  # keep the reference frame, try the next frame
        # build the 2-keyframe initial map
        R0, t0 = jnp.eye(3), jnp.zeros(3)
        self.map = steps.insert_keyframe(
            self.map, self.cfg.cam, ref, R0, t0, jnp.int32(self._init_frame_id))
        self.map = steps.insert_keyframe(
            self.map, self.cfg.cam, obs, res.R, res.t, jnp.int32(frame_id))
        self.map = steps.insert_landmarks_two_view(
            self.map, self.cfg.cam, jnp.int32(0), jnp.int32(1),
            idx, res.X, res.good & matched)
        self.map = steps.refresh_landmarks(self.map)
        # full BA over the two views (reference: 20 iters, Tracking.cc:787)
        self.map = steps.local_bundle_adjustment(
            self.map, self.cfg.cam, jnp.int32(1), iters_a=20)
        # gauge: median scene depth of KF0 -> 1 (reference :791-817)
        med = float(steps.scene_median_depth(self.map, jnp.int32(0)))
        n_tracked = int(jnp.sum(self.map.kf_lm[1] >= 0))
        if not np.isfinite(med) or med <= 0 or n_tracked < self.cfg.min_init_matches:
            # failed bootstrap: wipe and restart (reference :793-799)
            self.map = empty_map(self.cfg.map_cfg)
            self._init_obs = None
            return False
        self.map = steps.scale_map(self.map, jnp.float32(1.0 / med))
        self.n_kf_host = 2
        self.kf_uids = [0, 1]
        self._kf_uid_counter = 2
        self.ref_kf = 1
        self.last_kf_frame = frame_id
        self.last_R = self.map.kf_R[1]
        self.last_t = self.map.kf_t[1]
        self.last_obs = obs._replace(lm=self.map.kf_lm[1])
        self.state = TrackState.OK
        self._log_pose(frame_id, self.last_R, self.last_t)
        # place recognition on the packaged vocabulary (reference: the
        # pre-trained ORBvoc.txt loaded at System construction, System.cc:71)
        from ..place.database import KeyFrameDatabase
        from .loop_closing import LoopCloser
        self.db = KeyFrameDatabase(default_vocabulary(),
                                   self.map.kf_R.shape[0])
        self.db.add(0, ref.feats.desc, ref.feats.valid)
        self.db.add(1, obs.feats.desc, obs.feats.valid)
        self.loop_closer = LoopCloser(self.cfg.cam, self.db, fix_scale=False,
                                      width=self.cfg.width, height=self.cfg.height)
        self._init_obs = None
        return True

    def process_stereo(self, img_left, img_right, frame_id=None):
        """Track one rectified stereo frame; returns (R, t) or None
        (reference: System::TrackStereo System.cc:169 ->
        Tracking::GrabImageStereo Tracking.cc:168)."""
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()
        obs = self._frame_obs_stereo(img_left, img_right)
        return self._process_obs(obs, frame_id)

    def _process_obs(self, obs: steps.FrameObs, frame_id):
        """Generic (non-fused) per-frame flow shared by the stereo path:
        init -> motion-model/ref-KF track -> local map -> keyframe decision.
        """
        if self.state == TrackState.NOT_INITIALIZED:
            ok = self._initialize(obs, frame_id)
            return (self.last_R, self.last_t) if ok else None
        if self.state == TrackState.LOST:
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None
        R, t, obs, ok = self._track(obs, frame_id)
        if not ok:
            if self._lost_transition():
                return None  # lost-early reset (Tracking.cc:542-551)
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None
        self.state = TrackState.OK
        self.velocity = se3.compose(R, t, *se3.inverse(self.last_R, self.last_t))
        self.last_R, self.last_t = R, t
        self.last_obs = obs
        self._log_pose(frame_id, R, t)
        if not self.localization_only and self._need_new_keyframe(obs):
            self._create_keyframe(obs, R, t, frame_id)
        return R, t

    def _need_new_keyframe_stats(self, n_in, ref_matches,
                                 tracked_close, non_tracked_close,
                                 frame_id=None) -> bool:
        """NeedNewKeyFrame (reference: Tracking.cc:1140-1244) from the fused
        step's statistics vector — no extra device readbacks."""
        cfg = self.cfg
        if frame_id is None:
            frame_id = self.frame_count - 1
        # 1s keyframe embargo after relocalization once the map is mature
        # (reference: Tracking.cc:1150-1160)
        if (frame_id < self.last_reloc_frame + cfg.fps
                and self.n_kf_host > cfg.fps):
            return False
        frames_since = frame_id - self.last_kf_frame
        need_close = tracked_close < 100 and non_tracked_close > 70
        th_ref = 0.4 if self.n_kf_host < 2 else 0.75
        c1a = frames_since >= cfg.fps
        c1b = frames_since >= 3  # emulated mapping-thread duty cycle
        c1c = n_in < ref_matches * 0.25 or need_close
        c2 = (n_in < ref_matches * th_ref or need_close) and n_in > 15
        if self.n_kf_host >= self.map.kf_R.shape[0]:
            return False  # at capacity with growth disabled/pending
        return (c1a or c1b or c1c) and c2

    # -- phases ----------------------------------------------------------
    def _initialize(self, obs: steps.FrameObs, frame_id) -> bool:
        """StereoInitialization (reference: Tracking.cc:584-636): needs >500
        features; all depth points become landmarks of keyframe 0."""
        n_valid = int(jnp.sum(obs.feats.valid))
        if n_valid <= self.cfg.min_init_features:
            return False
        R = jnp.eye(3)
        t = jnp.zeros(3)
        self.map = steps.insert_keyframe(
            self.map, self.cfg.cam, obs, R, t, jnp.int32(frame_id))
        # init: ALL depth points become landmarks (Tracking.cc:599-627)
        self.map = steps.create_depth_landmarks(
            self.map, self.cfg.cam, jnp.int32(0), jnp.float32(1e9))
        self.n_kf_host += 1
        self.kf_uids = [0]
        self._kf_uid_counter = 1
        self.last_R, self.last_t = R, t
        self.last_obs = obs._replace(lm=self.map.kf_lm[0])
        self.ref_kf = 0
        self.last_kf_frame = frame_id
        self.state = TrackState.OK
        self._log_pose(frame_id, R, t)
        # place recognition on the packaged vocabulary (reference:
        # System.cc:71 loads the pre-trained ORBvoc.txt)
        from ..place.database import KeyFrameDatabase
        from .loop_closing import LoopCloser
        self.db = KeyFrameDatabase(default_vocabulary(),
                                   self.map.kf_R.shape[0])
        self.db.add(0, obs.feats.desc, obs.feats.valid)
        self.loop_closer = LoopCloser(self.cfg.cam, self.db, fix_scale=True,
                                      width=self.cfg.width, height=self.cfg.height)
        return True

    def _track(self, obs: steps.FrameObs, frame_id):
        cam = self.cfg.cam
        cfg = self.cfg
        res = None
        # motion-model window: 7 px stereo/RGB-D, 15 px monocular
        # (reference: Tracking.cc:1011-1024)
        th_mm = 15.0 if cfg.sensor == "mono" else 7.0
        if self.velocity is not None:
            Rv, tv = self.velocity
            R_pred, t_pred = se3.compose(Rv, tv, self.last_R, self.last_t)
            res = steps.track_motion_model(
                cam, self.map, self.last_obs, self.last_R, self.last_t,
                obs.feats, R_pred, t_pred, jnp.float32(th_mm),
                jnp.float32(cfg.width), jnp.float32(cfg.height),
                jnp.int32(cfg.desc_th))
            if int(res.n_inliers) < 10:
                # widened window retry (reference: Tracking.cc:1011-1024 2x th)
                res = steps.track_motion_model(
                    cam, self.map, self.last_obs, self.last_R, self.last_t,
                    obs.feats, R_pred, t_pred, jnp.float32(2 * th_mm),
                    jnp.float32(cfg.width), jnp.float32(cfg.height),
                    jnp.int32(cfg.desc_th))
            if int(res.n_inliers) < 10:
                res = None
        if res is None:
            res = steps.track_reference_keyframe(
                cam, self.map, jnp.int32(self.ref_kf), obs.feats,
                self.last_R, self.last_t)
            if int(res.n_inliers) < 10:
                return None, None, obs, False
        # local-map search radius (reference Tracking.cc:1393-1399): th=1,
        # 3 for RGB-D, 5 within 2 frames of a relocalization
        if frame_id < self.last_reloc_frame + 2:
            th_local = 5.0
        elif cfg.sensor == "rgbd":
            th_local = 3.0
        else:
            th_local = 1.0
        local_mask = steps.local_landmark_mask(self.map, jnp.int32(self.ref_kf))
        res2, self.map = steps.track_local_map(
            cam, self.map, obs.feats, res.lm, res.R, res.t,
            local_mask, jnp.float32(th_local), cfg.width, cfg.height,
            jnp.int32(cfg.desc_th_local))
        self._n_inliers = int(res2.n_inliers)
        # raised bar within 1s of relocalization (reference :1119-1126)
        min_in = 50 if frame_id < self.last_reloc_frame + cfg.fps else 30
        if self._n_inliers < min_in:
            return None, None, obs, False
        obs = obs._replace(lm=res2.lm)
        return res2.R, res2.t, obs, True

    def _need_new_keyframe(self, obs) -> bool:
        """NeedNewKeyFrame (reference: Tracking.cc:1140-1244), with the
        mapping thread always idle (synchronous local mapping)."""
        cfg = self.cfg
        frames_since = self.frame_count - 1 - self.last_kf_frame
        # ref-KF matched landmarks with >= minObs observations. The reference
        # counts a stereo/RGB-D observation as nObs += 2 (MapPoint.cc:105-108)
        # with thresholds 3 (map mature) / 2; our table counts keyframe SLOTS,
        # so the equivalent slot thresholds are 2 / 1.
        min_obs = 2 if self.n_kf_host > 2 else 1
        m = self.map
        ref_lm = m.kf_lm[self.ref_kf]
        has = (ref_lm >= 0) & m.kf_feat_valid[self.ref_kf]
        nobs = jnp.sum((m.lm_obs_kf[jnp.clip(ref_lm, 0)] >= 0), axis=1)
        ref_matches = int(jnp.sum(has & (nobs >= min_obs)
                                  & m.lm_valid[jnp.clip(ref_lm, 0)]))
        # close-point accounting (reference: Tracking.cc:1170-1193)
        depth_th = cfg.depth_threshold
        d = np.asarray(obs.depth)
        lm = np.asarray(obs.lm)
        close = (d > 0) & (d < depth_th)
        tracked_close = int(np.sum(close & (lm >= 0)))
        non_tracked_close = int(np.sum(close & (lm < 0)))
        need_close = tracked_close < 100 and non_tracked_close > 70
        n_in = self._n_inliers
        # 1s keyframe embargo after relocalization (Tracking.cc:1150-1160)
        if (self.frame_count - 1 < self.last_reloc_frame + cfg.fps
                and self.n_kf_host > cfg.fps):
            return False
        # reference: thRefRatio = 0.75 (0.9 mono), or 0.4 with a single
        # keyframe (Tracking.cc:1205-1210)
        if self.cfg.sensor == "mono":
            need_close = False
            th_ref = 0.9
        else:
            th_ref = 0.4 if self.n_kf_host < 2 else 0.75
        c1a = frames_since >= cfg.fps
        # c1b in the reference is "LocalMapping idle". With synchronous
        # mapping it would be constantly true, which makes keyframe insertion
        # fire on c2 alone, several times faster than the threaded reference
        # (whose mapping thread is busy ~0.1-0.3 s per keyframe). Emulate the
        # thread's duty cycle with a minimum spacing of 3 frames.
        c1b = frames_since >= 3
        c1c = n_in < ref_matches * 0.25 or need_close
        c2 = (n_in < ref_matches * th_ref or need_close) and n_in > 15
        if self.n_kf_host >= self.map.kf_R.shape[0]:
            return False  # at capacity with growth disabled/pending
        return (c1a or c1b or c1c) and c2

    def _create_keyframe(self, obs, R, t, frame_id):
        kf = self.n_kf_host
        if kf >= self.map.kf_R.shape[0]:
            # hard capacity guard — unreachable when maintenance margins
            # hold (growth happens _kf_margin keyframes early); refusing is
            # strictly safer than a clipped out-of-bounds scatter into the
            # last slot
            self._maintenance_due = True
            return
        if self.cfg.sensor == "mono":
            self.map = steps.keyframe_step_mono(
                self.map, self.cfg.cam, obs, R, t, jnp.int32(frame_id),
                self.cfg.width, self.cfg.height)
        else:
            self.map = steps.keyframe_step(
                self.map, self.cfg.cam, obs, R, t, jnp.int32(frame_id),
                jnp.float32(self.cfg.depth_threshold),
                self.cfg.width, self.cfg.height)
        self.n_kf_host += 1
        self.kf_uids.append(self._kf_uid_counter)
        self._kf_uid_counter += 1
        self.ref_kf = kf
        self.last_kf_frame = frame_id
        self.last_obs = obs._replace(lm=self.map.kf_lm[kf])
        # async map-counter fetch: drives landmark compaction/growth
        # decisions without a synchronous readback on the keyframe path
        z = _map_counters(self.map)
        try:
            z.copy_to_host_async()
        except Exception:
            pass
        self._counter_fut = self._reader.submit(np.asarray, z)
        if self.db is not None:
            self.db.add(kf, obs.feats.desc, obs.feats.valid)
            # loop detection: submit device work now, do the host gating on
            # the next frame (LoopCloser.begin/finish) — forcing it here
            # stalls on the freshly queued keyframe maintenance
            self._finish_pending_loop()
            self._pending_loop = self.loop_closer.begin(self.map, kf)

    def _reloc_project_round(self, obs, c, frame_lm, R, t, th, desc_th):
        """One escalation round of relocalization (reference:
        Tracking.cc:1716-1752): project the candidate keyframe's landmarks
        into the frame at the current pose estimate (SearchByProjection
        with radius th, descriptor gate ORBdist), add the new matches, and
        re-run pose-only optimization."""
        from ..matching import search as ms
        m = self.map
        cfg = self.cfg
        kf_lm = m.kf_lm[c]
        safe_lm = jnp.clip(kf_lm, 0)
        has = (kf_lm >= 0) & m.kf_feat_valid[c] & m.lm_valid[safe_lm]
        # exclude landmarks already matched into the frame
        L = m.lm_pw.shape[0]
        # scatter-add of 0/1 counts, not scatter-set of bools: clipped -1
        # entries would race True writes at slot 0 (duplicate-index
        # scatter-set is nondeterministic)
        already_lm = jnp.zeros(L, jnp.int32).at[jnp.clip(frame_lm, 0)].add(
            (frame_lm >= 0).astype(jnp.int32)) > 0
        has = has & ~already_lm[safe_lm]
        lmset = ms.LandmarkSet(
            m.lm_pw[safe_lm], m.lm_normal[safe_lm], m.lm_dmin[safe_lm],
            m.lm_dmax[safe_lm], m.lm_desc[safe_lm], has)
        fr = ms.frustum_check(cfg.cam, R, t, lmset, cfg.width, cfg.height)
        feat_used = frame_lm >= 0
        idx, dist, matched = ms.search_local_points(
            cfg.cam, R, t, lmset, fr, obs.feats, th=jnp.float32(th),
            already_matched=feat_used, desc_th=jnp.int32(desc_th))
        safe_idx = jnp.where(matched, idx, 0)
        frame_lm = frame_lm.at[safe_idx].set(
            jnp.where(matched, safe_lm, frame_lm[safe_idx]))
        tr = steps._pose_optimize_from_matches(
            cfg.cam, m, obs.feats, frame_lm, R, t)
        return tr, frame_lm

    def _relocalize(self, obs: steps.FrameObs, frame_id) -> bool:
        """Relocalization (reference: Tracking.cc:1582-1778): gated BoW
        candidates -> descriptor matching -> EPnP RANSAC -> pose-only
        optimization -> ESCALATING projection-search rounds (th=10 /
        ORBdist=100, then th=3 / ORBdist=64) until >=50 inliers, round-
        robin over candidates."""
        from ..matching import search as ms
        from ..matching.search import SIGMA2
        from ..solvers import pnp
        cands = self.db.detect_reloc_candidates(
            self.map, obs.feats.desc, obs.feats.valid, max_candidates=5)
        m = self.map
        cam = self.cfg.cam
        K = (self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy)
        for c in cands:
            kf_lm = m.kf_lm[c]
            kf_has = ((kf_lm >= 0) & m.kf_feat_valid[c]
                      & m.lm_valid[jnp.clip(kf_lm, 0)])
            idx, dist, matched = ms.search_brute(
                m.kf_desc[c], obs.feats.desc, kf_has, obs.feats.valid,
                ratio=0.75, angle_q=m.kf_angle[c], angle_t=obs.feats.angle)
            if int(jnp.sum(matched)) < 15:  # reference :1625
                continue
            N = obs.feats.xy.shape[0]
            frame_lm = jnp.full(N, -1, jnp.int32)
            safe = jnp.where(matched, idx, 0)
            frame_lm = frame_lm.at[safe].set(jnp.where(matched, kf_lm, -1))
            has = (frame_lm >= 0) & obs.feats.valid
            Xw = m.lm_pw[jnp.clip(frame_lm, 0)]
            key = jax.random.PRNGKey(self.frame_count)
            res = pnp.solve_ransac(
                key, K, Xw, obs.feats.xy,
                jnp.asarray(SIGMA2)[obs.feats.octave], has,
                max_iters=300)
            if int(res.n_inliers) < 10:
                continue
            tr = steps._pose_optimize_from_matches(
                cam, m, obs.feats, frame_lm, res.R, res.t)
            n_good = int(tr.n_inliers)
            if n_good < 10:
                continue
            if n_good < 50:
                # escalation round 1: wide search, loose descriptor gate
                # (reference :1716-1729, th=10, ORBdist=100)
                tr, frame_lm = self._reloc_project_round(
                    obs, c, tr.lm, tr.R, tr.t, th=10.0, desc_th=100)
                n_good = int(tr.n_inliers)
                if 30 <= n_good < 50:
                    # round 2: narrow search, tight gate (:1735-1750,
                    # th=3, ORBdist=64)
                    tr, frame_lm = self._reloc_project_round(
                        obs, c, tr.lm, tr.R, tr.t, th=3.0, desc_th=64)
                    n_good = int(tr.n_inliers)
            if n_good < 50:  # reference accepts at >=50 (:1752)
                continue
            self.last_R, self.last_t = tr.R, tr.t
            self.last_obs = obs._replace(lm=tr.lm)
            self.ref_kf = c
            self.velocity = None
            self.state = TrackState.OK
            self._n_inliers = n_good
            self.last_reloc_frame = frame_id
            self._log_pose(frame_id, tr.R, tr.t)
            return True
        return False

    # -- export ----------------------------------------------------------
    def trajectory_arrays(self):
        self.flush()
        ids = np.array([f for f, _, _ in self.trajectory])
        Rs = np.stack([np.asarray(R) for _, R, _ in self.trajectory])
        ts = np.stack([np.asarray(t) for _, _, t in self.trajectory])
        return ids, Rs, ts
