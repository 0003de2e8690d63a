"""geometry (PyTorch port): camera rays, voxel grids and pose math."""
