"""The benchmark's harness: the traffic, the window, the readings and the check."""
