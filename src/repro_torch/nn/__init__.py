"""Neural-network building blocks (``layers``) and models (``gnn``,
``recsys``, ``transformer``)."""
