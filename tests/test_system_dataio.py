"""System façade, settings parser, dataset loaders, rectification."""
import os

import numpy as np
import pytest

from orb_slam2_with_comment_tpu import Sensor, System
from orb_slam2_with_comment_tpu.dataio import settings as cfg
from orb_slam2_with_comment_tpu.dataio import datasets, rectify
from orb_slam2_with_comment_tpu.dataio.synthetic import SyntheticWorld, orbit_trajectory
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu.pipeline import TrackerConfig

TUM_YAML = """%YAML:1.0

# Camera Parameters.
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989

Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314

Camera.width: 640
Camera.height: 480

Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

EUROC_BLOCK = """
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283, 0.001365741834644127, 0.9999741760894847, 0.007055629199258132, -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947, 0.003680398547259526, 0.9999684752771629, -0.007035845251224894, -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
"""


class TestSettings:
    def test_parse_tum(self, tmp_path):
        p = tmp_path / "TUM1.yaml"
        p.write_text(TUM_YAML)
        s = cfg.load_settings(str(p))
        assert abs(s.fx - 517.306408) < 1e-6
        assert abs(s.cy - 255.313989) < 1e-6
        assert s.depth_map_factor == 5000.0
        assert s.n_features == 1000
        assert s.th_depth == 40.0
        np.testing.assert_allclose(
            s.dist, [0.262383, -0.953104, -0.005358, 0.002628, 1.163314])

    def test_parse_euroc_matrices(self, tmp_path):
        p = tmp_path / "EuRoC.yaml"
        p.write_text(TUM_YAML + EUROC_BLOCK)
        s = cfg.load_settings(str(p))
        assert s.left_rect is not None
        assert s.left_rect["K"].shape == (3, 3)
        assert abs(s.left_rect["K"][0, 0] - 458.654) < 1e-9
        assert s.right_rect["P"].shape == (3, 4)
        assert s.width == 752 and s.height == 480

    def test_rectify_map_matches_opencv(self, tmp_path):
        cv2 = pytest.importorskip("cv2")
        p = tmp_path / "EuRoC.yaml"
        p.write_text(TUM_YAML + EUROC_BLOCK)
        s = cfg.load_settings(str(p))
        L = s.left_rect
        ours = rectify.build_rectify_map(L["K"], L["D"], L["R"], L["P"],
                                         s.width, s.height)
        m1, m2 = cv2.initUndistortRectifyMap(
            L["K"], L["D"], L["R"], L["P"][:3, :3], (s.width, s.height),
            cv2.CV_32FC1)
        np.testing.assert_allclose(ours[..., 0], m1, atol=2e-2)
        np.testing.assert_allclose(ours[..., 1], m2, atol=2e-2)


class TestPngReading:
    """Frame reading without PIL: the PNG header gives the size, and with
    neither PIL nor the native loader the loaders say what is missing."""

    @staticmethod
    def _png(tmp_path, h=5, w=7):
        import struct
        import zlib

        def chunk(kind, data):
            body = kind + data
            return (struct.pack(">I", len(data)) + body
                    + struct.pack(">I", zlib.crc32(body)))

        raw = b"".join(b"\x00" + bytes(range(w)) for _ in range(h))
        path = tmp_path / "f.png"
        path.write_bytes(b"\x89PNG\r\n\x1a\n"
                         + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                      0, 0, 0, 0))
                         + chunk(b"IDAT", zlib.compress(raw))
                         + chunk(b"IEND", b""))
        return str(path)

    def test_png_size_from_header(self, tmp_path):
        assert datasets._png_size(self._png(tmp_path)) == (5, 7)
        bad = tmp_path / "x.png"
        bad.write_bytes(b"not a png at all, really not")
        with pytest.raises(ValueError):
            datasets._png_size(str(bad))

    @pytest.fixture
    def no_pil(self, monkeypatch):
        import builtins
        real_import = builtins.__import__

        def importer(name, *args, **kw):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError(name)
            return real_import(name, *args, **kw)

        monkeypatch.setattr(builtins, "__import__", importer)

    def test_native_decode_without_pil(self, tmp_path, no_pil):
        from orb_slam2_with_comment_tpu.dataio import native_loader
        if native_loader.get_lib() is None:
            pytest.skip("native loader needs g++ and libpng")
        img = datasets._imread_gray(self._png(tmp_path))
        np.testing.assert_array_equal(
            img, np.tile(np.arange(7, dtype=np.float32), (5, 1)))

    def test_clear_error_without_pil_or_native(self, tmp_path, no_pil,
                                                monkeypatch):
        from orb_slam2_with_comment_tpu.dataio import native_loader
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
        with pytest.raises(RuntimeError, match="Pillow or the native PNG"):
            datasets._imread_gray(self._png(tmp_path))


class TestTumAssociate:
    def test_greedy_pairing(self):
        rgb = [(0.00, "a"), (0.05, "b"), (0.10, "c")]
        dep = [(0.011, "x"), (0.049, "y"), (0.30, "z")]
        pairs = datasets.associate_tum(rgb, dep, max_diff=0.02)
        assert pairs == [(0, 0), (1, 1)]


@pytest.fixture(scope="module")
def system_run(tmp_path_factory):
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(n_frames=25)
    config = TrackerConfig(
        n_features=600, min_init_features=150,
        map_cfg=MapConfig(k_max=12, n_feat=600, l_max=4000, d_max=8), fps=10)
    slam = System(config=config, sensor=Sensor.RGBD)
    outs = []
    for k, (R, t) in enumerate(poses):
        img, depth = world.render(R, t)
        outs.append(slam.track_rgbd(img, depth, timestamp=k / 10.0))
    return slam, poses, outs


class TestSystem:
    def test_returns_pose44(self, system_run):
        slam, poses, outs = system_run
        ok = [o for o in outs if o is not None]
        assert len(ok) >= 0.7 * len(outs)
        T = ok[-1]
        assert T.shape == (4, 4)
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-3)

    def test_save_trajectory_tum(self, system_run, tmp_path):
        slam, poses, outs = system_run
        p = tmp_path / "traj.txt"
        slam.save_trajectory_tum(str(p))
        lines = p.read_text().strip().splitlines()
        assert len(lines) == len(slam.tracker.rel_log)
        vals = [float(x) for x in lines[0].split()]
        assert len(vals) == 8
        q = np.array(vals[4:])
        assert abs(np.linalg.norm(q) - 1) < 1e-5

    def test_save_trajectory_kitti(self, system_run, tmp_path):
        slam, *_ = system_run
        p = tmp_path / "kitti.txt"
        slam.save_trajectory_kitti(str(p))
        row = [float(x) for x in p.read_text().strip().splitlines()[0].split()]
        assert len(row) == 12
        R = np.array(row).reshape(3, 4)[:, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-3)

    def test_keyframe_trajectory(self, system_run, tmp_path):
        slam, *_ = system_run
        p = tmp_path / "kf.txt"
        slam.save_keyframe_trajectory_tum(str(p))
        lines = p.read_text().strip().splitlines()
        assert len(lines) == slam.tracker.n_kf_host

    def test_trajectory_accuracy_vs_gt(self, system_run, tmp_path):
        """Saved chain poses must agree with ground truth (the chain
        semantics must not corrupt poses)."""
        from orb_slam2_with_comment_tpu.evaluation.ate import (
            ate_rmse, camera_centers)
        slam, poses, outs = system_run
        rows = slam._chain_poses()
        est_R = np.stack([r[1] for r in rows])
        est_t = np.stack([r[2] for r in rows])
        ids = [fid for fid, *_ in slam.tracker.rel_log]
        gt_R = np.stack([poses[i][0] for i in ids])
        gt_t = np.stack([poses[i][1] for i in ids])
        rmse = ate_rmse(camera_centers(est_R, est_t),
                        camera_centers(gt_R, gt_t))
        assert rmse < 0.05, rmse

    def test_localization_mode(self, system_run):
        slam, poses, outs = system_run
        world = SyntheticWorld(seed=1)
        n_kf = slam.tracker.n_kf_host
        slam.activate_localization_mode()
        R, t = poses[-1]
        img, depth = world.render(R, t)
        for _ in range(3):
            slam.track_rgbd(img, depth)
        assert slam.tracker.n_kf_host == n_kf  # frozen map
        slam.deactivate_localization_mode()
