"""Neural-network building blocks (``layers``) and models (``recsys``)."""
