"""The benchmark's plain reference: SIFT features written out directly in
PyTorch (float64), importing nothing of the program under test."""
