"""Diagnostic run of the synthetic RGB-D pipeline with per-frame tracing."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from orb_slam2_with_comment_tpu.dataio.synthetic import SyntheticWorld, orbit_trajectory
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu.pipeline import Tracker, TrackerConfig, TrackState
from orb_slam2_with_comment_tpu.pipeline import steps
from orb_slam2_with_comment_tpu.geometry import se3

world = SyntheticWorld(n_points=400, seed=1)
poses = orbit_trajectory(n_frames=30)
cfg = TrackerConfig(n_features=600, min_init_features=150,
                    map_cfg=MapConfig(k_max=16, n_feat=600, l_max=4000, d_max=8),
                    fps=10)
tracker = Tracker(cfg)

for k, (R, t) in enumerate(poses):
    img, depth = world.render(R, t)
    obs = tracker._frame_obs(img, depth)
    nf = int(obs.feats.valid.sum())
    if tracker.state == TrackState.NOT_INITIALIZED:
        ok = tracker._initialize(obs, k)
        print(f"f{k}: feats={nf} INIT ok={ok} n_lm={int(tracker.map.n_lm)}")
        continue
    # manual trace of _track
    cam = cfg.cam
    info = {}
    res = None
    if tracker.velocity is not None:
        Rv, tv = tracker.velocity
        R_pred, t_pred = se3.compose(Rv, tv, tracker.last_R, tracker.last_t)
        res = steps.track_motion_model(
            cam, tracker.map, tracker.last_obs, tracker.last_R, tracker.last_t,
            obs.feats, R_pred, t_pred, jnp.float32(7.0),
            jnp.float32(cfg.width), jnp.float32(cfg.height))
        info["mm"] = (int(res.n_matches), int(res.n_inliers))
        if int(res.n_inliers) < 10:
            res = None
    if res is None:
        res = steps.track_reference_keyframe(
            cam, tracker.map, jnp.int32(tracker.ref_kf), obs.feats,
            tracker.last_R, tracker.last_t)
        info["ref"] = (int(res.n_matches), int(res.n_inliers))
        if int(res.n_inliers) < 10:
            print(f"f{k}: feats={nf} {info} -> LOST")
            tracker.state = TrackState.LOST
            break
    local_mask = steps.local_landmark_mask(tracker.map, jnp.int32(tracker.ref_kf))
    res2, tracker.map = steps.track_local_map(
        cam, tracker.map, obs.feats, res.lm, res.R, res.t,
        local_mask, jnp.float32(3.0), cfg.width, cfg.height)
    tracker._n_inliers = int(res2.n_inliers)
    info["local"] = (int(local_mask.sum()), int(res2.n_matches), int(res2.n_inliers))
    if tracker._n_inliers < 30:
        print(f"f{k}: feats={nf} {info} -> LOST(local)")
        tracker.state = TrackState.LOST
        break
    obs = obs._replace(lm=res2.lm)
    R2, t2 = res2.R, res2.t
    tracker.velocity = se3.compose(R2, t2, *se3.inverse(tracker.last_R, tracker.last_t))
    tracker.last_R, tracker.last_t = R2, t2
    tracker.last_obs = obs
    tracker._log_pose(k, R2, t2)
    need = tracker._need_new_keyframe(obs)
    # pose error vs GT
    C_est = -np.asarray(R2).T @ np.asarray(t2)
    C_gt = -R.T @ t
    err = np.linalg.norm(C_est - C_gt)
    print(f"f{k}: feats={nf} {info} kf={need} n_kf={tracker.n_kf_host} "
          f"n_lm={int(tracker.map.n_lm)} Cerr={err:.4f}")
    if need:
        tracker._create_keyframe(obs, R2, t2, k)
