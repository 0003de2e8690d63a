"""planner (PyTorch port): so far only the collision module's trilinear
interpolation, which the uncertainty-coloured mesh reads."""
