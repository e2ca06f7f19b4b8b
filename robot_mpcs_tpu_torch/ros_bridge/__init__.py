"""The ROS1 planner node and its offline solver generation (port of
``ros_bridge/``)."""
