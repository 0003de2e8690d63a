"""native (PyTorch port): the C++ marching-tets core and its g++ build."""
