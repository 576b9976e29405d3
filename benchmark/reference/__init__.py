"""The plain reference the served tokens are held against."""
