"""Data plane: IDX and NetCDF files (and the native reader core), MNIST
splits, normalisation, the batch loaders, convert and download."""
