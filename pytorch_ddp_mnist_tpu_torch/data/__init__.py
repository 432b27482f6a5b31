"""Data plane: IDX files, MNIST splits, normalisation and the batch loader."""
