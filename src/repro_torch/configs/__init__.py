"""Architecture and shape configs (``base``) and the per-arch modules that
register into it (``mind``)."""
