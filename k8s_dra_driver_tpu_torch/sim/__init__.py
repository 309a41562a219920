"""Virtual time for hermetic replays (clock.py)."""
