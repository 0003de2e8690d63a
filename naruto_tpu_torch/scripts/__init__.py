"""Entry points of the port that measure it on the card."""
