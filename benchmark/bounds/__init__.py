"""Least device times of the program's work, from the card's published peaks."""
