"""The launch layer: meshes (``mesh``), the cells and train steps
(``steps``), roofline terms (``roofline``), and the command-line entry
points ``serve``, ``train``, ``dryrun`` and ``profile_serve``."""
