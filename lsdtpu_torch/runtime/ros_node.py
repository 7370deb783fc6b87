"""Runnable ROS node around OnlineLocalizer - the reference's online
entry packaged as a daemon (counterpart of lsdtpu/runtime/ros_node.py;
reference: LSD/main_on_linux.cpp:33-46, identical wiring in
ROS/lsd/src/main_on_linux.cpp).

Layering:

  * ``LsdRosAdapter`` - the node's whole behavior over duck-typed
    message objects (anything with the ROS message fields).  Plain
    Python, testable without a ROS install: this is where the
    reference's callback semantics live.
  * ``main()`` / ``LsdNode`` - a thin rclpy (ROS 2) shell that wires the
    adapter to real subscriptions.  rclpy is imported only there, to
    run the node (``lsdtpu-torch-ros-node``).

Reference semantics kept exactly:

  * topics ``/map_metadata`` (MapMetaData), ``/map`` (OccupancyGrid),
    ``/scan`` (LaserScan) (main_on_linux.cpp:39-41);
  * mapCallback requires metadata first (``oriMapCol <= 0`` guard,
    main_on_linux.cpp:98-99), remaps the int8 grid bytes read as
    unsigned (255->0 unknown, 0->255 free, else->1 occupied,
    main_on_linux.cpp:108-124), builds mapCache with z_occ_max_dis=2 +
    LSD (main_on_linux.cpp:129-133) - map prep on the localizer's
    device, or the numpy oracle's with mapprep="oracle";
  * laserCallback drops while the map is not ready
    (main_on_linux.cpp:50-51) and drops INF readings, reconstructing
    angles incrementally (main_on_linux.cpp:54-64; the compaction bug
    there is fixed - see runtime/online.laser_scan_to_polar).

Deviations (ROS-native equivalents of the reference's OpenCV windows):
the estimated pose is returned per scan and, under rclpy, published as
geometry_msgs/PoseStamped on ``/lsd_pose`` instead of being drawn into
an imshow window (main_on_linux.cpp:78-84).  An optional ``/odom``
subscription feeds the tracking-mode UKF (the reference's linux node is
the pre-UKF legacy matcher and uses no odometry; mode="legacy" is
therefore the default).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.runtime.online import OnlineLocalizer


class LsdRosAdapter:
    """The node's behavior over duck-typed ROS messages."""

    def __init__(self, cfg: EngineConfig = DEFAULT, mode: str = "legacy",
                 dtype=np.float32, device="cuda", mapprep: str = "torch"):
        # mapprep: "torch" or "oracle", OnlineLocalizer's switch (the
        # reference adapter's use_tpu_mapprep)
        self.loc = OnlineLocalizer(cfg=cfg, mode=mode, dtype=dtype,
                                   device=device, mapprep=mapprep)
        self.mode = mode
        # mapParam global (main_on_linux.cpp:17-19,88-94)
        self._width = 0
        self._height = 0
        self._resol = 0.0
        self._ori_x = 0.0
        self._ori_y = 0.0
        self._odom: Optional[np.ndarray] = None
        self.n_map_lines: Optional[int] = None

    # -- callbacks --------------------------------------------------------
    def on_map_metadata(self, msg) -> None:
        """mapParamCallback (main_on_linux.cpp:88-94)."""
        self._width = int(msg.width)
        self._height = int(msg.height)
        self._resol = float(msg.resolution)
        self._ori_x = float(msg.origin.position.x)
        self._ori_y = float(msg.origin.position.y)

    def on_map(self, msg) -> Optional[int]:
        """mapCallback (main_on_linux.cpp:96-134): guard on metadata,
        remap the grid, rebuild artifacts.  Returns #map lines, or None
        when dropped (no metadata yet)."""
        if self._width <= 0 or self._height <= 0:
            return None
        self.n_map_lines = self.loc.set_map_occupancy_grid(
            np.asarray(msg.data), self._width, self._height,
            self._resol, self._ori_x, self._ori_y)
        return self.n_map_lines

    def on_odom(self, msg) -> None:
        """Optional nav_msgs/Odometry feed for tracking mode: stores
        [x, y, yaw] (yaw from the orientation quaternion).  The angle
        unit must match the dataset Odom.txt convention the main loop's
        delta math expects (main_on_windows.cpp:139-153)."""
        p = msg.pose.pose.position
        q = msg.pose.pose.orientation
        yaw = math.atan2(2.0 * (q.w * q.z + q.x * q.y),
                         1.0 - 2.0 * (q.y * q.y + q.z * q.z))
        self._odom = np.array([p.x, p.y, yaw], np.float64)

    def on_scan(self, msg) -> Optional[dict]:
        """laserCallback (main_on_linux.cpp:48-86): isMapReady guard,
        INF drop, featurize + match.  Returns the per-frame outputs
        (pose in map px, pose_world in meters, score, ...), or None
        when dropped (map not ready / all readings INF)."""
        if not self.loc.is_map_ready:
            return None     # isMapReady guard (main_on_linux.cpp:50-51)
        ranges = np.asarray(msg.ranges, np.float64)
        if not np.isfinite(ranges).any():
            return None     # len_lp == 0 (main_on_linux.cpp:67)
        return self.loc.push_laser_scan(
            ranges, float(msg.angle_min), float(msg.angle_increment),
            odom=self._odom if self.mode == "tracking" else None)


def main(argv=None) -> int:  # pragma: no cover - requires a ROS install
    """``lsdtpu-torch-ros-node``: run the adapter under rclpy (ROS 2),
    on the card."""
    try:
        import rclpy
        from rclpy.node import Node
    except ImportError:
        import sys
        print("lsdtpu-torch-ros-node needs rclpy (a ROS 2 Python install); "
              "the adapter itself is importable without it: "
              "lsdtpu_torch.runtime.ros_node.LsdRosAdapter", file=sys.stderr)
        return 2
    from geometry_msgs.msg import PoseStamped
    from nav_msgs.msg import MapMetaData, OccupancyGrid, Odometry
    from sensor_msgs.msg import LaserScan

    class LsdNode(Node):
        def __init__(self):
            # node name mirrors the reference (main_on_linux.cpp:37)
            super().__init__("laser_listener")
            self.declare_parameter("mode", "legacy")
            mode = self.get_parameter("mode").value
            self.adapter = LsdRosAdapter(mode=mode)
            # queue depth 1 like the reference (main_on_linux.cpp:39-41)
            self.create_subscription(MapMetaData, "/map_metadata",
                                     self.adapter.on_map_metadata, 1)
            self.create_subscription(OccupancyGrid, "/map", self._map, 1)
            self.create_subscription(LaserScan, "/scan", self._scan, 1)
            self.create_subscription(Odometry, "/odom",
                                     self.adapter.on_odom, 1)
            self.pub = self.create_publisher(PoseStamped, "/lsd_pose", 1)

        def _map(self, msg):
            n = self.adapter.on_map(msg)
            if n is not None:
                self.get_logger().info(f"map ready: {n} lines")

        def _scan(self, msg):
            out = self.adapter.on_scan(msg)
            if out is None:
                return
            ps = PoseStamped()
            ps.header.stamp = self.get_clock().now().to_msg()
            ps.header.frame_id = "map"
            ps.pose.position.x = float(out["pose_world"][0])
            ps.pose.position.y = float(out["pose_world"][1])
            ang = math.radians(float(out["pose"][2]))
            ps.pose.orientation.z = math.sin(ang / 2.0)
            ps.pose.orientation.w = math.cos(ang / 2.0)
            self.pub.publish(ps)

    rclpy.init(args=argv)
    node = LsdNode()
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        node.destroy_node()
        rclpy.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
