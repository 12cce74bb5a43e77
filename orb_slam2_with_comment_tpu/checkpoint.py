"""Map / session checkpointing: the SaveMap/LoadMap the reference never had.

The reference lists map serialization as an explicit TODO (reference:
include/System.h:115-117); its only persistent output is trajectory text.
Because this framework's map is a flat SoA pytree of fixed-capacity arrays
(mapstate.map.MapState), checkpointing is a direct array dump — no pointer
graph surgery. Tracker session state (pose, velocity, counters, relative
trajectory log) rides along so a run can resume mid-sequence, and a saved
map can be reloaded for localization-only operation.
"""
from __future__ import annotations

import json

import numpy as np
import jax.numpy as jnp

from .mapstate.map import MapState


def save_map(path: str, m: MapState) -> None:
    """Serialize a MapState to one .npz file."""
    arrays = {f: np.asarray(getattr(m, f)) for f in m._fields}
    np.savez_compressed(path, **arrays)


def load_map(path: str) -> MapState:
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    fields = {f: (jnp.asarray(data[f]) if f in data.files
                  else jnp.int32(0))  # counters added after a save
              for f in MapState._fields}
    return MapState(**fields)


def save_auto_state(path: str, tracker) -> None:
    """Checkpoint an AutoTracker (pipeline.auto): the entire device-side
    AutoState pytree (map + pose/velocity/flags + trajectory ring +
    loop-closing carry) in one dump — the functional-state design makes
    resume trivial. NOTE: this is a device->host readback that waits for
    the device: do it at session boundaries (pipeline/auto.py
    docstring)."""
    flat, _ = _flatten_state(tracker.state)
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    arrays["auto_meta_json"] = np.frombuffer(json.dumps({
        "frame_count": tracker.frame_count,
        "timestamps": tracker.timestamps,
    }).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_auto_state(path: str, tracker) -> None:
    """Restore an AutoTracker checkpoint into a compatibly-configured
    tracker (same capacities / vocabulary)."""
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    flat, treedef = _flatten_state(tracker.state)
    import jax
    leaves = [jnp.asarray(data[k]) for k in flat]
    tracker.state = jax.tree.unflatten(treedef, leaves)
    meta = json.loads(bytes(data["auto_meta_json"]).decode())
    tracker.frame_count = meta["frame_count"]
    tracker.timestamps = list(meta["timestamps"])


def _flatten_state(state):
    """Stable name->leaf mapping for an AutoState pytree."""
    import jax
    leaves, treedef = jax.tree.flatten(state)
    return {f"auto_{i:03d}": leaf for i, leaf in enumerate(leaves)}, treedef


def save_session(path: str, tracker) -> None:
    """Checkpoint map + tracker host state (resumable mid-sequence)."""
    from .pipeline.tracking import TrackState
    tracker.flush()  # finalize the in-flight pipelined frame first
    arrays = {f"map_{f}": np.asarray(getattr(tracker.map, f))
              for f in tracker.map._fields}
    arrays["last_R"] = np.asarray(tracker.last_R)
    arrays["last_t"] = np.asarray(tracker.last_t)
    if tracker.velocity is not None:
        arrays["vel_R"] = np.asarray(tracker.velocity[0])
        arrays["vel_t"] = np.asarray(tracker.velocity[1])
    if tracker.rel_log:
        arrays["rel_frame"] = np.asarray([r[0] for r in tracker.rel_log])
        arrays["rel_ts"] = np.asarray([r[1] for r in tracker.rel_log])
        arrays["rel_ref"] = np.asarray([r[2] for r in tracker.rel_log])
        arrays["rel_R"] = np.stack([np.asarray(r[3]) for r in tracker.rel_log])
        arrays["rel_t"] = np.stack([np.asarray(r[4]) for r in tracker.rel_log])
    if tracker.kf_archive:
        uids = sorted(tracker.kf_archive)
        arrays["arch_uid"] = np.asarray(uids, np.int64)
        arrays["arch_anchor"] = np.asarray(
            [tracker.kf_archive[u][0] for u in uids], np.int64)
        arrays["arch_R"] = np.stack([tracker.kf_archive[u][1] for u in uids])
        arrays["arch_t"] = np.stack([tracker.kf_archive[u][2] for u in uids])
    meta = {
        "state": tracker.state.name,
        "ref_kf": int(tracker.ref_kf),
        "last_kf_frame": int(tracker.last_kf_frame),
        "frame_count": int(tracker.frame_count),
        "n_kf_host": int(tracker.n_kf_host),
        "n_inliers": int(tracker._n_inliers),
        "sensor": tracker.cfg.sensor,
        "kf_uids": list(tracker.kf_uids),
        "kf_uid_counter": int(tracker._kf_uid_counter),
    }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_session(path: str, tracker) -> None:
    """Restore map + host state into an existing (configured) Tracker."""
    from .pipeline.tracking import TrackState
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    fields = {f: jnp.asarray(data[f"map_{f}"]) for f in MapState._fields}
    tracker.map = MapState(**fields)
    meta = json.loads(bytes(data["meta_json"]).decode())
    tracker.state = TrackState[meta["state"]]
    tracker.ref_kf = meta["ref_kf"]
    tracker.last_kf_frame = meta["last_kf_frame"]
    tracker.frame_count = meta["frame_count"]
    tracker.n_kf_host = meta["n_kf_host"]
    tracker._n_inliers = meta["n_inliers"]
    tracker.kf_uids = list(meta.get("kf_uids",
                                    range(meta["n_kf_host"])))
    tracker._kf_uid_counter = int(
        meta.get("kf_uid_counter", meta["n_kf_host"]))
    tracker.kf_archive = {}
    if "arch_uid" in data:
        anchors = (data["arch_anchor"] if "arch_anchor" in data
                   else np.full(len(data["arch_uid"]), -1, np.int64))
        for i, u in enumerate(data["arch_uid"]):
            tracker.kf_archive[int(u)] = (
                int(anchors[i]), data["arch_R"][i], data["arch_t"][i])
    tracker.last_R = jnp.asarray(data["last_R"])
    tracker.last_t = jnp.asarray(data["last_t"])
    tracker.velocity = ((jnp.asarray(data["vel_R"]), jnp.asarray(data["vel_t"]))
                        if "vel_R" in data else None)
    tracker.rel_log = []
    if "rel_frame" in data:
        for i in range(len(data["rel_frame"])):
            tracker.rel_log.append(
                (int(data["rel_frame"][i]), float(data["rel_ts"][i]),
                 int(data["rel_ref"][i]), data["rel_R"][i], data["rel_t"][i]))
    # tracking after resume needs a fresh reference observation; the next
    # frame will relocalize/track against the restored map. Rebuild the
    # place-recognition index from keyframe descriptors.
    if tracker.n_kf_host > 0 and tracker.db is None:
        from .place.database import KeyFrameDatabase
        from .pipeline.loop_closing import LoopCloser
        from .pipeline.tracking import default_vocabulary
        tracker.db = KeyFrameDatabase(default_vocabulary(),
                                      tracker.map.kf_R.shape[0])
        for k in range(tracker.n_kf_host):
            tracker.db.add(k, tracker.map.kf_desc[k],
                           tracker.map.kf_feat_valid[k])
        tracker.loop_closer = LoopCloser(
            tracker.cfg.cam, tracker.db,
            fix_scale=tracker.cfg.sensor != "mono",
            width=tracker.cfg.width, height=tracker.cfg.height)
    # last_obs is rebuilt from the reference keyframe's stored features
    from .matching.search import FeatureSet
    from .pipeline import steps
    k = tracker.ref_kf
    m = tracker.map
    fs = FeatureSet(m.kf_xy[k], m.kf_ur[k], m.kf_octave[k], m.kf_angle[k],
                    m.kf_desc[k], m.kf_feat_valid[k])
    tracker.last_obs = steps.FrameObs(fs, m.kf_depth[k], m.kf_lm[k])
