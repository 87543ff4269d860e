"""Architecture and shape configs (``base``) and the per-arch modules that
register into it (``mind``); the paper's evaluation matrix (``grasp_paper``)."""
