"""Step builders of the port: serving only (the training half waits for
ROADMAP.md queue 1 item 4)."""
