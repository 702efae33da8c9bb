"""Data path of the port: ImageFolder datasets, transforms, the sharded
loader and the device prefetch."""
