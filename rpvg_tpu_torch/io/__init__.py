"""Host I/O: alignment streaming, info files, output writers."""
