"""Data and plans for driving the port end to end."""
