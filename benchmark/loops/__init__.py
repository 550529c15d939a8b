"""Loop kinds: each drives the program for one kind of traffic mix."""
