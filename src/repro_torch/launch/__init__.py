"""Entry points of the port's LM half: step builders and the serving command."""
