"""Launch-side helpers of the port: the streaming-traffic roofline model."""
