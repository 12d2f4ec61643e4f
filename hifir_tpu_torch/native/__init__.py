"""The native host library: its C++ sources (``src/``) and builder."""
