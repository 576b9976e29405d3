"""Debug utilities (cross-device differential comparison)."""
