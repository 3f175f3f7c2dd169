"""The configurations' own frozen references (`references/<name>.py`,
found by name: `spec.py`) and the plain modules they build on."""
