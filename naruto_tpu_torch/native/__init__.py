"""native (PyTorch port): the C++ marching-tets and raycaster cores and
their g++ build."""
