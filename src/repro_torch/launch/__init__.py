"""Launch-side code of the port: the step factories (``steps``), the
trainer (``train``) and the serving CLI (``serve``), and the
streaming-traffic roofline model (``roofline``)."""
