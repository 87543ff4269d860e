"""Architecture and shape configs (``base``) and the per-arch modules that
register into it (``gin_tu``, ``pna``, ``egnn``, ``nequip``, ``mind``); the
paper's evaluation matrix (``grasp_paper``)."""
