"""The wearable's on-device perception nets (Table I)."""
