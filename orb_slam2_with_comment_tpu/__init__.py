"""orb_slam2_with_comment_tpu — a sparse visual SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of ORB-SLAM2
(reference: AHzZ123/orb_slam2_with_comment, annotated fork of raulmur/ORB_SLAM2):
monocular / stereo / RGB-D tracking, local mapping, loop closing, relocalization,
and trajectory export — built SoA-first with fixed-capacity masked arrays,
batched Levenberg–Marquardt + Schur bundle adjustment and vmapped RANSAC.

Layer map (mirrors SURVEY.md §1, re-designed accelerator-first):
  geometry/   SE3/Sim3 Lie ops, triangulation           (ref: Converter, g2o types)
  models/     camera projection models (pinhole/stereo)  (ref: Frame projection code)
  ops/        XLA kernels: FAST, BRIEF, Hamming          (ref: ORBextractor, ORBmatcher)
  frontend/   ORB extraction pipeline, stereo depth      (ref: ORBextractor, Frame)
  matching/   data-association search modes              (ref: ORBmatcher)
  optim/      batched LM / Schur BA / pose graph         (ref: Optimizer + g2o)
  solvers/    H/F initializer, EPnP, Sim3 Horn RANSAC    (ref: Initializer, PnPsolver, Sim3Solver)
  place/      binary BoW vocabulary + scoring            (ref: DBoW2, KeyFrameDatabase)
  mapstate/   SoA map: keyframes, landmarks, covisibility(ref: Map, KeyFrame, MapPoint)
  pipeline/   tracking / local mapping / loop closing    (ref: Tracking, LocalMapping, LoopClosing, System)
  dataio/     dataset loaders, YAML config, trajectories (ref: Examples drivers)
  evaluation/ ATE / RPE metrics                          (ref: external TUM scripts)
  parallel/   mesh sharding, distributed BA              (new; SURVEY §2.5 P7)
"""

__version__ = "0.1.0"

from .system import Sensor, System  # noqa: E402,F401
