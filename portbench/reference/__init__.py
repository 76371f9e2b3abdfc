"""Plain PyTorch references the comparison holds the program to; they
import nothing of the program."""
