"""geometry (PyTorch port): camera rays and voxel grids."""
