"""pmv_tpu — monocular visual odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
JeanElsner/practical-multi-view (C++/OpenCV/Ceres KITTI monocular VO):

- ``pmv_tpu.core``      geometry (reference pose/projection conventions), state tables
- ``pmv_tpu.frontend``  corner extraction + pyramidal Lucas-Kanade tracking (XLA + Pallas)
- ``pmv_tpu.solvers``   batched RANSAC essential-matrix + PnP solvers
- ``pmv_tpu.ba``        Levenberg-Marquardt bundle adjustment with Schur complement
- ``pmv_tpu.parallel``  device-mesh sharding, distributed BA, pose-graph stitching
- ``pmv_tpu.pipeline``  the orchestrator (init, per-frame step, metrics, error file)
- ``pmv_tpu.io``        KITTI parsers, synthetic data, native prefetch runtime
- ``pmv_tpu.viz``       trajectory map / annotated video rendering
"""

__version__ = "0.1.0"
