"""Launch-side code of the port: the step factories (``steps``), the
trainer (``train``) and the serving CLI (``serve``), the meshes of ranks
over ``torch.distributed`` (``mesh``), and the streaming-traffic roofline
model (``roofline``)."""
