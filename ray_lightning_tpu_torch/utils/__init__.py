"""Small helpers of the port (device resolution, weight dequantisation)."""
