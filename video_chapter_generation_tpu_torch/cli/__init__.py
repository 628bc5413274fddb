"""Command-line entry points of the port (counterparts of the JAX
package's cli/)."""
