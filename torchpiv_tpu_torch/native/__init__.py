"""Native (C++) host code of the port: the bulk frame decoder."""
