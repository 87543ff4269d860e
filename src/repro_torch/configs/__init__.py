"""Architecture and shape configs (``base``) and the per-arch modules that
register into it (the LMs ``minitron_8b``, ``starcoder2_7b``,
``phi35_moe_42b_a6_6b``, ``moonshot_v1_16b_a3b``, ``nemotron4_340b``; the
GNNs ``gin_tu``, ``pna``, ``egnn``, ``nequip``; ``mind``); the paper's
evaluation matrix (``grasp_paper``)."""
