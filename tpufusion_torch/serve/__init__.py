"""Single-frame lidar server facade."""
