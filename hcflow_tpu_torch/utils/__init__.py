"""The port's utilities: option files (``config``), checkpoints (``checkpoint``,
``orbax``, ``ocdbt``, ``zstd``), metrics, logging and profiling.  Each is imported by
name; the package imports none of them, so that any module of the port can import
``profiling`` without importing the models."""
