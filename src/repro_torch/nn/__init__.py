"""Neural-network building blocks of the LM path."""
